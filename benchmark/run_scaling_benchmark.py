#!/usr/bin/env python
"""Expert-parallel scaling benchmark (1 -> N devices).

Tokens/s of the Mixtral-geometry MoE layer as experts shard across a mesh.
On several GPUs this measures interconnect scaling; on one device or the CPU
it still validates the sharded path end to end on a virtual mesh (pass JAX_PLATFORMS=cpu +
--xla_force_host_platform_device_count=8) and prints per-device-count
latencies.

Usage:
  python benchmark/run_scaling_benchmark.py --config debug --tokens 64
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmark/run_scaling_benchmark.py --config debug --virtual
"""
import argparse
import os
import sys
import time

import numpy as np

import _bootstrap  # noqa: F401
import jax
import jax.numpy as jnp

from fused4bit.layers.moe import QuantizedMoE, simulate_router_logits, topk_route
from fused4bit.models.config import get_config_by_name
from fused4bit.parallel.expert_parallel import moe_ep_replicated
from fused4bit.parallel.mesh import make_mesh
from fused4bit.parallel.sharding import shard_qt_experts
from fused4bit.quant import quantize


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="debug")
    p.add_argument("--tokens", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--output", default=None)
    p.add_argument("--virtual", action="store_true",
                   help="force the CPU platform (virtual multi-device mesh)")
    args = p.parse_args(argv)

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    cfg = get_config_by_name(args.config)
    n_dev_total = len(jax.devices())
    print(f"backend: {jax.default_backend()}  devices: {n_dev_total}")

    rng = np.random.default_rng(0)
    E, K, N, T = cfg.num_experts, cfg.hidden_dim, cfg.ffn_dim, args.tokens
    w = jnp.asarray(rng.standard_normal((E, N, K)) * 0.02, jnp.float32)
    qt_full = quantize(w, layout="planar")
    x = jnp.asarray(rng.standard_normal((T, K)), jnp.float32)
    logits = simulate_router_logits(jax.random.PRNGKey(0), T, E)

    golden = QuantizedMoE(weight=qt_full)(x, topk_route(logits, cfg.top_k, E))

    counts = [d for d in (1, 2, 4, 8) if d <= n_dev_total and E % d == 0]
    from fused4bit.parallel.expert_parallel import (
        moe_ep_a2a, moe_ep_a2a_dropless,
    )

    def ici_bytes(strategy, d, t, k_, n_, top_k):
        """Per-device interconnect bytes per layer call (analytic accounting).

        replicated: psum of the [T, N] partial output (bidirectional ring:
          ~2*(d-1)/d of the buffer crosses the wire per device).
        a2a (capacity): static send+recv buffers both ways regardless of
          routing: 2 * D*C*(H bytes) + return 2 * D*C*(N bytes).
        a2a_dropless: only REAL routed pairs move: expected (d-1)/d of
          T_loc*top_k pairs leave the device, each H bytes out + N bytes
          back (bf16=2B assumed; +4B eid channel forward).
        """
        bf = 2
        if d == 1:
            return 0
        if strategy == "replicated":
            return int(2 * (d - 1) / d * t * n_ * bf)
        t_loc = t // d
        if strategy == "a2a":
            cap = max(int(2.0 * t_loc * top_k / d), 16)
            return int(2 * d * cap * (k_ + n_) * bf)
        # dropless: expected off-device fraction (d-1)/d of local pairs
        pairs = t_loc * top_k
        off = pairs * (d - 1) / d
        return int(off * ((k_ * bf + 4) + n_ * bf))

    results = {}
    for strategy, fn_s in (
        ("replicated", moe_ep_replicated),
        ("a2a", moe_ep_a2a),
        ("a2a_dropless", moe_ep_a2a_dropless),
    ):
        print(f"\n--- strategy: {strategy} ---")
        print(f"{'devices':>8} {'ms/layer':>10} {'tokens/s':>10} "
              f"{'max err':>9} {'link KB/dev':>11}")
        for d in counts:
            if strategy != "replicated" and (T % d or d == 1):
                continue
            mesh = make_mesh(("expert",), (d,), devices=jax.devices()[:d])
            qt = shard_qt_experts(qt_full, mesh, "expert")
            kw = dict(top_k=cfg.top_k, tile_m=16)
            fn = lambda: fn_s(x, logits, qt, mesh, **kw)  # noqa: E731
            try:
                out = fn()
                err = float(jnp.max(jnp.abs(out - golden)))
                jax.block_until_ready(out)
            except Exception as exc:
                print(f"{d:>8} [skip] {type(exc).__name__}: {str(exc)[:80]}")
                continue
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                np.asarray(fn())  # host fetch = true barrier
                ts.append(time.perf_counter() - t0)
            med = sorted(ts)[len(ts) // 2]
            kb = ici_bytes(strategy, d, T, K, N, cfg.top_k) / 1e3
            print(f"{d:>8} {med*1e3:>10.3f} {T/med:>10.0f} {err:>9.4f} "
                  f"{kb:>11.1f}")
            results.setdefault(strategy, {})[d] = dict(
                ms=round(med * 1e3, 3), max_err=round(err, 5),
                ici_kb_per_dev=round(kb, 1),
            )
    if args.output:
        import json
        with open(args.output, "w") as f:
            json.dump({"config": cfg.name, "tokens": T,
                       "backend": jax.default_backend(),
                       "note": ("virtual-CPU latencies are "
                                "NOT hardware-representative; the artifact "
                                "documents correctness across device counts "
                                "and the analytic per-device interconnect bytes of "
                                "each strategy"),
                       "results": results}, f, indent=2)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
