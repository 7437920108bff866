#!/usr/bin/env python
"""Fused INT4-KV attention vs dequantize-then-attend, true per-op latency.

The INT4 KV cache is the reference's long-context motivation bullet
(`README.md:112`) built out: this measures the fused
flash-decoding kernel (packed cache dequantized in-kernel, never
materialized) against the jnp fallback (materialize bf16 K/V, dense
attention) across context lengths, using the slope protocol
(utils.benchmark.time_fn_slope) so the fixed per-iteration cost is
differenced out.

Usage: python benchmark/run_attention_benchmark.py --contexts 1024 4096 8192
"""
import argparse
import json
import os
import sys

import numpy as np

import _bootstrap  # noqa: F401

import jax
import jax.numpy as jnp

from fused4bit.layers.kv_cache import QuantizedKVCache
from fused4bit.ops.decode_attention import int4_decode_attention
from fused4bit.utils.benchmark import time_fn_slope
from fused4bit.utils.device_profile import device_op_times

# Mixtral head geometry
B, NH, NKV, D = 8, 32, 8, 128

# Keep each timed chain's KV working set above the 50 MB L2 cache so caches
# stream from device memory like a real multi-layer model's.
_MIN_CHAIN_BYTES = 256 * 1024 * 1024


def time_attention_device(fn, q, caches, traces=3):
    """Per-call device seconds: one jit applying `fn` over DISTINCT caches
    (data-dependent chain), module device time / calls, min over traces."""
    treedef = jax.tree.structure(caches[0])
    per = len(jax.tree.leaves(caches[0]))
    allflat = [leaf for c in caches for leaf in jax.tree.leaves(c)]

    @jax.jit
    def f(q, *fl):
        y = q
        for i in range(len(caches)):
            c = jax.tree.unflatten(treedef, fl[i * per:(i + 1) * per])
            y = jnp.sin(fn(y, c) + y)  # consume + nonlinear carry
        return y

    run = lambda: np.asarray(f(q, *allflat))  # noqa: E731
    run()  # compile + warm
    best = None
    for _ in range(traces):
        prof = device_op_times(run)
        t = prof.main_module_ms() / len(caches)
        best = t if best is None or t < best else best
    return best / 1e3


def build(ctx, seed=0):
    key = jax.random.PRNGKey(seed)
    cache = QuantizedKVCache.init(B, NKV, ctx, D)
    # fill the whole context in chunks (device-side)
    chunk = 512
    for s in range(0, ctx, chunk):
        k1, k2, key = jax.random.split(key, 3)
        kv_shape = (B, NKV, chunk, D)
        cache = cache.append(
            jax.random.normal(k1, kv_shape, jnp.bfloat16),
            jax.random.normal(k2, kv_shape, jnp.bfloat16),
            start=jnp.full((B,), s, jnp.int32),
        )
    q = jax.random.normal(key, (B, NH, D), jnp.bfloat16)
    return jax.block_until_ready(q), jax.tree.map(jax.block_until_ready, cache)


def jnp_attention(q, cache):
    """Dequantize-everything fallback (the honest non-fused baseline)."""
    kd, vd = cache.dequantize(dtype=q.dtype)      # [B, NKV, S, D] bf16
    rep = NH // NKV
    kd = jnp.repeat(kd, rep, axis=1)
    vd = jnp.repeat(vd, rep, axis=1)
    scores = jnp.einsum("bhd,bhsd->bhs", q, kd) / jnp.sqrt(float(D))
    span = jnp.arange(cache.max_seq)[None, None, :]
    mask = span < cache.lengths[:, None, None]
    scores = jnp.where(mask, scores.astype(jnp.float32), -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhs,bhsd->bhd", probs, vd)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--contexts", type=int, nargs="*", default=[1024, 4096, 8192])
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results",
        "attention_sweep.json"))
    args = p.parse_args(argv)

    print(f"backend: {jax.default_backend()}  B={B} NH={NH} NKV={NKV} D={D}")
    results = {}
    if os.path.exists(args.out):
        results = json.load(open(args.out))
    for ctx in args.contexts:
        q, cache = build(ctx)
        cell = results.setdefault(f"ctx{ctx}", {})
        kv_bytes_packed = cache.k_packed.size * 2 + cache.k_scale.size * 2 * 4 * 2
        # Correctness first — BOTH impls against an f64 host golden on the
        # same dequantized cache (a bf16 baseline drifts with context on
        # its own; the golden does not).
        kd, vd = cache.dequantize(dtype=jnp.float32)
        kd64 = np.repeat(np.asarray(kd), NH // NKV, axis=1).astype(np.float64)
        vd64 = np.repeat(np.asarray(vd), NH // NKV, axis=1).astype(np.float64)
        del kd, vd
        qn = np.asarray(q, np.float32).astype(np.float64)
        sc = np.einsum("bhd,bhsd->bhs", qn, kd64) / np.sqrt(float(D))
        sc -= sc.max(-1, keepdims=True)
        pr = np.exp(sc)
        pr /= pr.sum(-1, keepdims=True)
        gold = np.einsum("bhs,bhsd->bhd", pr, vd64)
        scale = max(np.abs(gold).max(), 1e-9)
        del kd64, vd64, sc, pr
        got = np.asarray(int4_decode_attention(q, cache), np.float64)
        base = np.asarray(jnp_attention(q, cache), np.float64)
        rel = np.abs(got - gold).max() / scale
        cell["verify_rel_err"] = round(float(rel), 5)
        cell["baseline_rel_err"] = round(
            float(np.abs(base - gold).max() / scale), 5
        )
        n_caches = max(2, int(np.ceil(_MIN_CHAIN_BYTES / kv_bytes_packed)))
        print(f"\n=== ctx={ctx} (packed KV {kv_bytes_packed/1e6:.0f} MB x "
              f"{n_caches} distinct caches) "
              f"verify rel {rel:.4f} {'OK' if rel < 3e-2 else 'FAIL'} ===",
              flush=True)
        caches = [cache] + [build(ctx, seed=i + 1)[1]
                            for i in range(n_caches - 1)]
        for name, fn in (
            ("int4_fused", lambda qq, c: int4_decode_attention(qq, c)),
            ("dequant_jnp", lambda qq, c: jnp_attention(qq, c)),
        ):
            sec = time_attention_device(fn, q, caches, traces=args.repeats)
            cell[name] = round(sec * 1e3, 4)
            base = cell.get("dequant_jnp")
            sp = (f"  ({base / cell[name]:.2f}x vs dequant)"
                  if base and name == "int4_fused" else "")
            print(f"  {name:<12} {sec*1e3:8.3f} ms{sp}", flush=True)
        del caches
        if "int4_fused" in cell and "dequant_jnp" in cell:
            cell["speedup"] = round(cell["dequant_jnp"] / cell["int4_fused"], 3)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    results["_meta"] = dict(
        geometry=f"B={B} NH={NH} NKV={NKV} D={D} (Mixtral heads), decode T=1",
        protocol=(
            "device-trace module time over a chain of distinct HBM-resident "
            "caches (>=256 MB working set; utils/device_profile)"
        ),
        backend=jax.default_backend(),
        note="int4_fused reads the PACKED cache (4x fewer KV bytes) and "
             "never materializes bf16 K/V; dequant_jnp materializes the "
             "whole cache then attends",
    )
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
