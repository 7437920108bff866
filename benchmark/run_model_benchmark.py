#!/usr/bin/env python
"""Model-level decode throughput: INT4 model vs its dense bf16 twin.

Mixtral-geometry INT4 decode tokens/s per device vs the bf16 baseline. The dense twin is produced by
*dequantizing* the INT4 model (`models/dense_baseline.py`), so both models
compute the same function — the comparison isolates the execution strategy
(packed INT4 kernels + INT4 KV cache vs dense bf16 matmuls + bf16 KV cache).

Usage: python benchmark/run_model_benchmark.py [--scale small] [--batch 8]
"""
import argparse
import sys

import numpy as np

import _bootstrap  # noqa: F401
import jax
import jax.numpy as jnp

from fused4bit.models.config import flagship_model_config
from fused4bit.models.dense_baseline import dense_from_quantized
from fused4bit.models.transformer import QuantizedTransformer
from fused4bit.utils.benchmark import time_fn


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="small", choices=["tiny", "small", "full"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--prefill", type=int, default=0,
                   help="measure PREFILL of this many tokens across "
                        "execution modes instead of decode")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    cfg = flagship_model_config(args.scale)
    print(f"model: {cfg.name}  layers={cfg.num_layers} hidden="
          f"{cfg.num_heads * cfg.head_dim} experts={cfg.moe.num_experts} "
          f"ffn={cfg.moe.ffn_dim} top{cfg.moe.top_k}")

    model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    dense = dense_from_quantized(model)
    print(f"weights+embed: int4 {model.nbytes/1e6:.0f} MB   "
          f"bf16 {dense.nbytes/1e6:.0f} MB   "
          f"({dense.nbytes/model.nbytes:.1f}x reduction)")

    b = args.batch
    qcaches = model.init_cache(cfg, b, args.max_seq)
    dcaches = dense.init_cache(cfg, b, args.max_seq)
    print(f"KV cache @ max_seq={args.max_seq}: int4 "
          f"{sum(c.nbytes for c in qcaches)/1e6:.0f} MB   bf16 "
          f"{sum(c.nbytes for c in dcaches)/1e6:.0f} MB")

    # Real autoregressive decode: chained greedy steps inside ONE jit
    # (lax.scan carrying the KV caches): fresh token inputs per repeat and
    # median-of-repeats with an explicit block_until_ready per run.
    steps = args.iters
    import time

    def run(m, caches):
        @jax.jit
        def loop(m, caches, tok0, pos0):
            def body(carry, _):
                tok, caches, pos = carry
                logits, caches = m(tok, caches, pos)
                nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
                return (nxt, caches, pos + 1), nxt

            _, toks = jax.lax.scan(body, (tok0, caches, pos0), None, length=steps)
            return toks

        pos0 = jnp.zeros((b, 1), jnp.int32)
        np.asarray(loop(m, caches, jnp.zeros((b, 1), jnp.int32), pos0))  # compile
        ts = []
        for r in range(4):
            tok0 = jnp.full((b, 1), r + 3, jnp.int32)
            t0 = time.perf_counter()
            loop(m, caches, tok0, pos0).block_until_ready()
            ts.append((time.perf_counter() - t0) / steps)
        return sorted(ts)[len(ts) // 2]

    if args.prefill:
        return prefill_bench(args, cfg, model, dense)

    tq = run(model, qcaches)
    td = run(dense, dcaches)

    print(f"\nautoregressive decode (batch {b}, {steps} chained steps):")
    print(f"  int4 model: {tq*1e3:8.3f} ms/step  -> {b/tq:8.0f} tokens/s")
    print(f"  bf16 model: {td*1e3:8.3f} ms/step  -> {b/td:8.0f} tokens/s")
    print(f"  speedup: {td/tq:.2f}x")
    return 0


def prefill_bench(args, cfg, model, dense):
    """Model-level PREFILL throughput across execution modes.

    One forward of a [B, T] prompt (T = --prefill) through the kernel
    model, `as_u4_turbo` (packed residency, transient-i8 prefill),
    `as_xla_turbo` (i8-resident), and the dense bf16 twin.
    """
    import json
    import time

    from fused4bit.models.transformer import as_u4_turbo, as_xla_turbo

    b, t = args.batch, args.prefill
    if t % 2:
        t += 1  # pair-packed KV cache needs an even capacity
    toks = jnp.zeros((b, t), jnp.int32)
    pos = jnp.arange(t)

    def run_prefill(m):
        @jax.jit
        def fwd(m, toks, caches):
            logits, _ = m(toks, caches, pos)
            return jnp.sum(jnp.abs(logits[:, -1]))

        caches = m.init_cache(cfg, b, max(args.max_seq, t))
        np.asarray(fwd(m, toks, caches))  # compile
        ts = []
        for r in range(4):
            tk = jnp.full((b, t), r + 3, jnp.int32)
            t0 = time.perf_counter()
            np.asarray(fwd(m, tk, caches))  # host fetch = true barrier
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    rows = {}
    for name, m in (
        ("int4-kernel", model),
        ("u4_turbo", as_u4_turbo(model)),
        ("xla_turbo", as_xla_turbo(model)),
        ("bf16-dense", dense),
    ):
        try:
            sec = run_prefill(m)
        except Exception as err:
            rows[name] = {"error": str(err)[:200]}
            print(f"  {name:<12} FAILED {str(err)[:120]}")
            continue
        rows[name] = {
            "ms": round(sec * 1e3, 2),
            "tokens_per_s": round(b * t / sec, 0),
        }
        print(f"  {name:<12} {sec*1e3:8.2f} ms   {b*t/sec:10.0f} tokens/s")
    if "ms" in rows.get("bf16-dense", {}):
        for k in ("int4-kernel", "u4_turbo", "xla_turbo"):
            if "ms" in rows.get(k, {}):
                rows[k]["speedup_vs_bf16"] = round(
                    rows["bf16-dense"]["ms"] / rows[k]["ms"], 2
                )
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "geometry": f"{cfg.name} B={b} T={t}",
                "protocol": "single prefill forward, host-fetch barrier, "
                            "median of 4 fresh-input repeats",
                "results": rows,
            }, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
