#!/usr/bin/env python
"""Linear-kernel benchmark + roofline (reference parity).

Counterpart of the reference's `benchmark/run_benchmark.py`: sweeps the
same weight shapes ((1024,1024), (4096,4096), (4096,11008),
`run_benchmark.py:54-58`), compares the fused INT4 kernel against the
framework-native full-precision matmul (bf16 XLA here vs fp16 cuBLAS there),
reports latency / weight memory / roofline (bytes, FLOPs, arithmetic
intensity, achieved GB/s — `run_benchmark.py:205-242`).

Usage: python benchmark/run_benchmark.py [--batch 8] [--iters 100] [--quick]
       python benchmark/run_benchmark.py --sweep-batch 1 8 32 128 256 \
           --json linear_batch_sweep.json
"""
import argparse
import json
import os
import sys

import numpy as np

import _bootstrap  # noqa: F401  (repo-root import shim)

import jax
import jax.numpy as jnp

from fused4bit.ops.int4_matmul import int4_matmul
from fused4bit.quant import quantize
from fused4bit.utils.benchmark import BenchmarkResult, print_table, time_fn_scan, time_fn_slope
from fused4bit.utils.roofline import linear_roofline

SHAPES = [(1024, 1024), (4096, 4096), (4096, 11008)]  # (in, out), ref :54-58


def bench_shape(in_dim, out_dim, batch, iters, measured_bw=None, slope=False,
                chain=32):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((out_dim, in_dim)), dtype=jnp.float32)
    wb = w.astype(jnp.bfloat16)
    qt = quantize(w)
    x = jnp.asarray(rng.standard_normal((batch, in_dim)), dtype=jnp.bfloat16)

    # weights as consts (jit args), not closures: closure constants lower
    # to literal HLO constants
    kw = dict(consts=None, iters=6, repeats=4)
    if slope:
        t_dense = time_fn_slope(lambda v, w: v @ w.T, x, consts=(wb,),
                                iters=6, repeats=4, chain=chain)
        t_int4 = time_fn_slope(lambda v, q: int4_matmul(v, q), x, consts=(qt,),
                               iters=6, repeats=4, chain=chain)
    else:
        t_dense = time_fn_scan(lambda v, w: v @ w.T, x, consts=(wb,),
                               iters=min(iters, 8), repeats=3)
        t_int4 = time_fn_scan(lambda v, q: int4_matmul(v, q), x, consts=(qt,),
                              iters=min(iters, 8), repeats=3)

    dense_bytes = out_dim * in_dim * 2
    print(f"\n=== {in_dim} -> {out_dim}, batch={batch} ===")
    print_table(
        [
            BenchmarkResult("bf16 dense (XLA)", t_dense * 1e3, num_tokens=batch),
            BenchmarkResult("int4 fused (Pallas)", t_int4 * 1e3, num_tokens=batch),
        ],
        baseline="bf16 dense (XLA)",
    )
    print(
        f"weight memory: bf16 {dense_bytes/1e6:.1f} MB -> int4 "
        f"{qt.nbytes/1e6:.1f} MB ({dense_bytes*2/qt.nbytes:.1f}x vs fp32, "
        f"{dense_bytes/qt.nbytes:.1f}x vs bf16)"
    )
    rep = linear_roofline(
        batch, in_dim, out_dim, measured_s=t_int4, measured_hbm_gbps=measured_bw
    )
    print(rep.pretty())
    return t_dense, t_int4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--quick", action="store_true", help="only the largest shape")
    p.add_argument(
        "--measured-bw", type=float, default=None,
        help="empirical device-memory GB/s to use as the roofline denominator",
    )
    p.add_argument(
        "--sweep-batch", type=int, nargs="*", default=None,
        help="batch sweep (1-256) on the flagship "
             "4096->11008 shape; writes per-batch dense/int4 ms + achieved "
             "GB/s to --json",
    )
    p.add_argument("--json", default=None, help="write results JSON here")
    p.add_argument("--slope", action="store_true",
                   help="TRUE per-op latency (time_fn_slope) - otherwise "
                        "numbers include the per-iteration dispatch cost")
    p.add_argument("--plot", default=None,
                   help="write latency/memory bar charts here (reference "
                        "parity: run_benchmark.py:244-288)")
    args = p.parse_args(argv)

    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    out = {}
    if args.sweep_batch:
        in_dim, out_dim = SHAPES[-1]
        for b in args.sweep_batch:
            t_dense, t_int4 = bench_shape(
                in_dim, out_dim, b, args.iters, args.measured_bw, args.slope
            )
            int4_bytes = in_dim * b * 2 + out_dim * in_dim // 2 + out_dim * 8
            dense_bytes = in_dim * b * 2 + out_dim * in_dim * 2
            out[f"batch{b}"] = {
                "bf16_ms": round(t_dense * 1e3, 4),
                "int4_ms": round(t_int4 * 1e3, 4),
                "speedup": round(t_dense / t_int4, 3),
                "int4_achieved_gbps": round(int4_bytes / t_int4 / 1e9, 1),
                "bf16_achieved_gbps": round(dense_bytes / t_dense / 1e9, 1),
            }
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(out, f, indent=2)
    else:
        shapes = SHAPES[-1:] if args.quick else SHAPES
        for in_dim, out_dim in shapes:
            t_dense, t_int4 = bench_shape(
                in_dim, out_dim, args.batch, args.iters, args.measured_bw,
                args.slope,
            )
            out[f"{in_dim}x{out_dim}_b{args.batch}"] = {
                "bf16_ms": round(t_dense * 1e3, 4),
                "int4_ms": round(t_int4 * 1e3, 4),
            }
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=2)
    if args.plot and out:
        plot_results(out, args.plot)
    return 0


def plot_results(out, path):
    """Latency + weight-memory bar charts (reference plot parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = list(out)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    xs = range(len(keys))
    ax1.bar([x - 0.2 for x in xs], [out[k]["bf16_ms"] for k in keys], 0.4,
            label="bf16 dense (XLA)", color="#888888")
    ax1.bar([x + 0.2 for x in xs], [out[k]["int4_ms"] for k in keys], 0.4,
            label="int4 fused (Pallas)", color="#1f77b4")
    ax1.set_ylabel("latency (ms)")
    in_dim, out_dim = SHAPES[-1]
    ax2.bar([0, 1], [out_dim * in_dim * 4 / 1e6, out_dim * in_dim * 2 / 1e6,
                     ][0:2], 0.5, color="#888888", label="dense")
    ax2.bar([2], [(out_dim * in_dim // 2 + out_dim * 8) / 1e6], 0.5,
            color="#1f77b4", label="int4+scales")
    ax2.set_xticks([0, 1, 2])
    ax2.set_xticklabels(["fp32", "bf16", "int4"])
    ax2.set_ylabel("weight MB")
    for ax in (ax1, ax2):
        ax.legend(fontsize=8)
        ax.grid(axis="y", alpha=0.3)
    ax1.set_xticks(list(xs))
    ax1.set_xticklabels(keys, fontsize=7, rotation=20)
    fig.suptitle(f"INT4 linear {in_dim}->{out_dim}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
