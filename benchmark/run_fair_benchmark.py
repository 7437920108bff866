#!/usr/bin/env python
"""Fair comparison: same weights, same inputs, every implementation.

Counterpart of the reference's `benchmark/run_fair_benchmark.py:49-172`:
all implementations consume the *identical* dense weights (quantized variants
derive from them) and identical routed inputs; reports latency, effective
TFLOPS, and weight memory side by side.
"""
import argparse
import sys

import numpy as np

import _bootstrap  # noqa: F401
import jax
import jax.numpy as jnp

from fused4bit.layers.moe import dispatch, make_dispatch_plan, simulate_router_logits, topk_route
from fused4bit.models.config import get_config_by_name
from fused4bit.ops.grouped_matmul import grouped_int4_matmul
from fused4bit.quant import dequantize, quantize
from fused4bit.utils.benchmark import time_fn


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mixtral")
    p.add_argument("--tokens", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--tile-m", type=int, default=16)
    args = p.parse_args(argv)

    cfg = get_config_by_name(args.config)
    E, K, N = cfg.num_experts, cfg.hidden_dim, cfg.ffn_dim
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((E, N, K)) * 0.02, dtype=jnp.float32)

    # One set of weights; every impl derives from it (the "fair" part).
    wb = w.astype(jnp.bfloat16)
    qt = jax.block_until_ready(jax.jit(lambda a: quantize(a, layout="planar"))(w))

    x = jnp.asarray(rng.standard_normal((args.tokens, K)), dtype=jnp.bfloat16)
    routing = topk_route(
        simulate_router_logits(jax.random.PRNGKey(0), args.tokens, E), cfg.top_k, E
    )
    plan = make_dispatch_plan(routing, E, tile_m=args.tile_m)
    xs = dispatch(x, routing, plan)
    cap = plan.t_pad // E
    flops = 2 * plan.t_pad * N * K

    impls = {
        "bf16 bmm": jax.jit(
            lambda v: jnp.einsum("eck,enk->ecn", v[: E * cap].reshape(E, cap, K), wb)
        ),
        "int4 fused": jax.jit(
            lambda v: grouped_int4_matmul(v, plan.tile_group_ids, qt, tile_m=args.tile_m)
        ),
        "int4 dequant+bmm": jax.jit(
            lambda v: jnp.einsum(
                "eck,enk->ecn",
                v[: E * cap].reshape(E, cap, K),
                dequantize(qt, dtype=jnp.bfloat16),
            )
        ),
    }
    mem = {
        "bf16 bmm": wb.size * 2,
        "int4 fused": qt.nbytes,
        "int4 dequant+bmm": qt.nbytes,
    }

    print(f"{'impl':<20} {'ms':>9} {'TFLOP/s':>9} {'weights':>10}")
    print("-" * 52)
    rows = []
    for name, fn in impls.items():
        t = time_fn(lambda: fn(xs), warmup=3, iters=args.iters)
        rows.append((name, t))
        print(f"{name:<20} {t*1e3:>9.3f} {flops/t/1e12:>9.2f} {mem[name]/1e6:>8.0f}MB")
    base = rows[0][1]
    for name, t in rows[1:]:
        print(f"{name}: {base/t:.2f}x vs {rows[0][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
