#!/usr/bin/env python
"""Sequence-parallel (ring attention) scaling evidence.

The long-context scale-out axis (SURVEY §2.5 SP row): attention with the
sequence dim sharded over a `seq` mesh axis. For each ring size P this
script runs both ring variants — bf16 K/V and the PACKED-INT4-cache ring
(`parallel.sequence`) — verifies them against the single-device golden, and
records the analytic interconnect accounting that makes the packed ring the right
design: each hop moves u8 codes + f32 scales instead of bf16 K/V, ~3.5x
fewer bytes at D=128.

On one device or the CPU this validates the sharded path on a virtual mesh
(JAX_PLATFORMS=cpu + --xla_force_host_platform_device_count=8) and records
CPU latencies for shape comparison only; on several GPUs the same script
measures true interconnect scaling.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmark/run_sp_benchmark.py --virtual --ctx 2048
"""
import argparse
import json
import time

import numpy as np

import _bootstrap  # noqa: F401
import jax
import jax.numpy as jnp


def golden(q, kd, vd, causal=True):
    rep = q.shape[1] // kd.shape[1]
    kr = jnp.repeat(kd, rep, axis=1).astype(jnp.float32)
    vr = jnp.repeat(vd, rep, axis=1).astype(jnp.float32)
    t = q.shape[2]
    s = jnp.einsum(
        "bhid,bhjd->bhij", q.astype(jnp.float32), kr
    ) / (q.shape[-1] ** 0.5)
    if causal:
        cm = jnp.arange(t)[None, :] <= jnp.arange(t)[:, None]
        s = jnp.where(cm[None, None], s, -1e30)
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(s, axis=-1), vr)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", type=int, default=2048)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--virtual", action="store_true")
    p.add_argument("--out", default="sp_scaling.json")
    args = p.parse_args(argv)

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    from fused4bit.layers.kv_cache import QuantizedKVCache
    from fused4bit.parallel.mesh import make_mesh
    from fused4bit.parallel.sequence import (
        ring_attention,
        ring_attention_quantized,
    )

    b, hq, hkv, t, d = (
        args.batch, args.heads, args.kv_heads, args.ctx, args.head_dim
    )
    n_total = len(jax.devices())
    print(f"backend: {jax.default_backend()}  devices: {n_total}")
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((b, hq, t, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, t, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, t, d)), jnp.float32)
    cache = QuantizedKVCache.init(b, hkv, t, d).append(k, v)
    kd, vd = cache.dequantize(jnp.float32)  # same-cache golden inputs
    want = np.asarray(golden(q, kd, vd), np.float32)
    nrm = np.linalg.norm(want)

    results = {}
    sizes = [s for s in (1, 2, 4, 8) if s <= n_total and t % s == 0]
    for p_sz in sizes:
        mesh = make_mesh(("seq",), (p_sz,), devices=jax.devices()[:p_sz])
        row = {}
        for name, fn, kv_bytes_hop in (
            (
                "ring_bf16",
                lambda: ring_attention(
                    q.astype(jnp.bfloat16), kd.astype(jnp.bfloat16),
                    vd.astype(jnp.bfloat16), mesh,
                ),
                # per hop per device: K+V chunk in bf16
                2 * b * hkv * (t // p_sz) * d * 2,
            ),
            (
                "ring_int4",
                lambda: ring_attention_quantized(q, cache, mesh),
                # packed codes (u8 pair-packed halves the rows) + 4 f32 rows
                2 * b * hkv * (t // p_sz) * d // 2
                + 4 * b * hkv * (t // p_sz) * 4,
            ),
        ):
            got = np.asarray(fn(), np.float32)
            rel = float(np.linalg.norm(got - want) / nrm)
            # the docstring's "verifies" must be load-bearing: fail loudly
            # instead of writing an artifact with a silently-broken column
            tol = 1e-2 if name == "ring_bf16" else 1e-4
            assert rel < tol, f"P={p_sz} {name}: rel {rel} exceeds {tol}"
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                np.asarray(fn())
                ts.append(time.perf_counter() - t0)
            hops = p_sz - 1
            row[name] = {
                "verify_rel_err": round(rel, 5),
                "wall_ms": round(sorted(ts)[len(ts) // 2] * 1e3, 2),
                "ici_bytes_per_hop_per_dev": kv_bytes_hop,
                "ici_bytes_total_per_dev": kv_bytes_hop * hops,
            }
            print(
                f"P={p_sz} {name:<10} rel={rel:.2e} "
                f"link/hop={kv_bytes_hop/1e3:.1f} KB x{hops} hops"
            )
        if p_sz > 1:
            row["ici_ratio_bf16_over_int4"] = round(
                row["ring_bf16"]["ici_bytes_per_hop_per_dev"]
                / row["ring_int4"]["ici_bytes_per_hop_per_dev"], 2
            )
        results[f"P{p_sz}"] = row

    doc = {
        "geometry": f"B={b} Hq={hq} Hkv={hkv} D={d} ctx={t}",
        "backend": jax.default_backend(),
        "protocol": (
            "verify vs single-device same-cache golden; analytic per-device "
            "interconnect accounting (wall_ms on a virtual CPU mesh is not "
            "a device latency — correctness + byte-model evidence)"
        ),
        "results": results,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
