#!/usr/bin/env python3
"""Sweep the INT4 matmul kernel's block sizes on the GPU at decode widths.

    python benchmark/tune_kernel_blocks.py [--out tune_kernel_blocks.json]

At the Mixtral-8x7B shapes (decode M=8 linears, the grouped MoE at T=8 and
T=2048 over 8 experts, prefill-size linears) it times `int4_kernel_call` at
each (block_n, block_kh, k_splits, num_warps, num_stages) and prints the
fastest beside the current choice of `ops.int4_matmul.kernel_blocks`, and the
plain XLA version where prefill might prefer it. It also records what a large
copy and a large bf16 matmul reach, and writes one profiler trace. Times are
medians per call over enough distinct weights that the L2 cache cannot hold
them. Needs a GPU.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import Widths, _weights, card_info, copies_for, time_call  # noqa: E402
from fused4bit.layers.moe import (  # noqa: E402
    dispatch, make_dispatch_plan, simulate_router_logits, topk_route,
)
from fused4bit.ops.grouped_matmul import grouped_int4_matmul_plain  # noqa: E402
from fused4bit.ops.int4_matmul import (  # noqa: E402
    int4_kernel_call, int4_matmul, int4_matmul_plain, kernel_blocks,
)


def _stack(qt):
    import dataclasses

    return dataclasses.replace(
        qt, packed=qt.packed[None], scales=qt.scales[None],
        zero_points=qt.zero_points[None], shape=(1,) + tuple(qt.shape))


def sweep(name, x, gids, qts, block_m, grid):
    e, n, k = qts[0].shape
    gs = qts[0].group_size if qts[0].granularity == "per_group" else 0
    current = kernel_blocks(block_m, n, k // 2, gs, grouped=e > 1)
    rows = []
    for bn, bkh, splits, (nw, ns) in grid:
        kw = dict(block_m=block_m, block_n=bn, block_kh=bkh, k_splits=splits,
                  num_warps=nw, num_stages=ns, compute_dtype=jnp.bfloat16,
                  out_dtype=jnp.bfloat16, interpret=False)
        cfg = f"bn={bn} bkh={bkh} split={splits} w={nw} s={ns}"
        try:
            t = time_call(lambda a, g, q: int4_kernel_call(a, g, q, **kw),
                          [(x, gids, q) for q in qts], 10)
        except Exception as exc:  # a block the compiler refuses
            print(f"  {name} {cfg}: {type(exc).__name__}", flush=True)
            continue
        rows.append(dict(block_n=bn, block_kh=bkh, k_splits=splits,
                         num_warps=nw, num_stages=ns, us=t * 1e6))
        print(f"  {name} {cfg}: {t * 1e6:.1f} us", flush=True)
    rows.sort(key=lambda r: r["us"])
    if not rows:
        raise RuntimeError(f"{name}: no block configuration compiled")
    t_cur = time_call(
        lambda a, g, q: int4_kernel_call(
            a, g, q, block_m=block_m, compute_dtype=jnp.bfloat16,
            out_dtype=jnp.bfloat16, interpret=False, **current),
        [(x, gids, q) for q in qts], 10)
    print(f"best {name}: {rows[0]}; current {current}: {t_cur * 1e6:.1f} us",
          flush=True)
    return dict(shape=[e, n, k], current=current, current_us=t_cur * 1e6,
                results=rows)


def calibrate() -> dict:
    """What a large copy and a large bf16 matmul reach on this card."""
    a = jnp.zeros((1 << 30,), jnp.uint8)
    t = time_call(lambda v: v + 1, [(a,)], 10)
    m = jax.random.normal(jax.random.PRNGKey(0), (8192, 8192)).astype(jnp.bfloat16)
    tm = time_call(lambda p, q: p @ q, [(m, m)], 10)
    out = dict(copy_gb_s=2 * a.size / t / 1e9,
               bf16_matmul_tflop_s=2 * 8192 ** 3 / tm / 1e12)
    print(f"calibration: {out}", flush=True)
    return out


def trace_one(x, qts, path) -> None:
    """A profiler trace of one timed call, for the trace reduction."""
    many = jax.jit(lambda sets: [int4_matmul(a, q) for a, q in sets])
    sets = [(x, q) for q in qts]
    jax.block_until_ready(many(sets))
    with jax.profiler.trace(path, create_perfetto_trace=True):
        jax.block_until_ready(many(sets))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tune_kernel_blocks.json",
                    help="results JSON; the trace goes beside it")
    args = ap.parse_args()
    device = card_info()
    w = Widths()
    out = dict(device=device, calibration=calibrate(), linear={},
               grouped={}, prefill={})
    key = jax.random.PRNGKey(0)
    decode = list(itertools.product(
        (32, 64), (128, 256), (1, 2, 4, 8), ((4, 4),)))
    for n, k, gran in ((w.ffn, w.hidden, "per_row"), (w.hidden, w.ffn, "per_row"),
                       (w.qkv, w.hidden, "per_row"), (w.vocab, w.hidden, "per_row"),
                       (w.hidden, w.ffn, "per_group")):
        qts = [_stack(q) for q in _weights(
            jax.random.fold_in(key, n), (n, k), gran, w,
            copies_for(n * k // 2, w))]
        x = jax.random.normal(key, (w.decode_m, k)).astype(jnp.bfloat16)
        gids = jnp.zeros((1,), jnp.int32)
        grid = [g for g in decode if gran == "per_row" or g[1] <= w.group_size]
        out["linear"][f"{gran} {k}->{n}"] = sweep(
            f"linear {gran} {k}->{n}", x, gids, qts, 16, grid)
        if n == w.ffn:
            trace_one(x, [q for q in _weights(key, (n, k), gran, w, 2)],
                      os.path.join(os.path.dirname(args.out), "trace_linear"))
    for t, tile_m, grid in (
        (8, 16, [g for g in decode if g[1] == 128 and g[2] <= 4]),
        (2048, 128, list(itertools.product(
            (64, 128), (32, 64), (1,), ((4, 3), (8, 3), (8, 2))))),
    ):
        for n, k in ((w.ffn, w.hidden), (w.hidden, w.ffn)):
            qts = _weights(jax.random.fold_in(key, n + t), (w.experts, n, k),
                           "per_row", w, 2)
            routing = topk_route(simulate_router_logits(key, t, w.experts),
                                 w.top_k, w.experts)
            plan = make_dispatch_plan(routing, w.experts, tile_m=tile_m)
            xs = dispatch(jax.random.normal(key, (t, k)).astype(jnp.bfloat16),
                          routing, plan)
            gids = plan.tile_group_ids
            res = sweep(f"grouped T={t} {k}->{n}", xs, gids, qts, tile_m, grid)
            res["plain_us"] = 1e6 * time_call(
                lambda a, g, q: grouped_int4_matmul_plain(
                    a, g, q, tile_m, jnp.bfloat16).astype(jnp.bfloat16),
                [(xs, gids, q) for q in qts], 10)
            print(f"  plain grouped T={t} {k}->{n}: {res['plain_us']:.1f} us",
                  flush=True)
            out["grouped"][f"T={t} {k}->{n}"] = res
    for m in (64, 512):
        n, k = w.ffn, w.hidden
        qts = [_stack(q) for q in _weights(key, (n, k), "per_row", w, 4)]
        x = jax.random.normal(key, (m, k)).astype(jnp.bfloat16)
        res = sweep(f"linear M={m} {k}->{n}", x, jnp.zeros((m // 64,), jnp.int32),
                    qts, 64, list(itertools.product(
                        (64, 128), (32, 64), (1,), ((4, 3), (8, 3)))))
        res["plain_us"] = 1e6 * time_call(
            lambda a, q: int4_matmul_plain(a, q), [(x, q) for q in
            _weights(key, (n, k), "per_row", w, 4)], 10)
        print(f"  plain linear M={m}: {res['plain_us']:.1f} us", flush=True)
        out["prefill"][f"M={m} {k}->{n}"] = res
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
