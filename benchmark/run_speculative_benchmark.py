#!/usr/bin/env python
"""Speculative decoding throughput: tokens/s vs the plain decode loop.

Speculation converts one target weight stream into 1..gamma+1 tokens; it
also divides the host dispatch cost across the accepted block (2 dispatches
per round instead of 1 per token). Two
draft configurations bound the envelope:

* ``self``  — draft == target: acceptance 1.0, gamma+1 tokens per round.
  The upper bound of the mechanics (all overhead, maximum savings).
* ``tiny``  — an independent tiny draft: acceptance ~0 on random weights
  (real acceptance depends on how well the draft tracks the target — with
  trained model pairs expect 0.6-0.9). The lower bound: every round pays
  gamma+1 draft steps + 1 verify and yields 1 token.

Compare against the plain loop at the same batch.
"""
import argparse
import sys
import time

import numpy as np

import _bootstrap  # noqa: F401
import jax
import jax.numpy as jnp

from fused4bit.models.config import flagship_model_config
from fused4bit.models.transformer import QuantizedTransformer
from fused4bit.serving.speculative import SpeculativeDecoder


def plain_tokens_per_s(model, cfg, prompts, max_new):
    import dataclasses

    b = len(prompts)
    lens = np.array([len(p) for p in prompts], np.int32)
    t_max = int(lens.max())
    max_seq = ((t_max + max_new + 4) // 2) * 2
    caches = model.init_cache(cfg, b, max_seq)
    toks = np.zeros((b, t_max), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : lens[i]] = p
    positions = jnp.broadcast_to(
        jnp.arange(t_max, dtype=jnp.int32)[None], (b, t_max)
    )
    logits, caches = model(jnp.asarray(toks), caches, positions)
    caches = tuple(
        dataclasses.replace(c, lengths=jnp.asarray(lens)) for c in caches
    )
    last = jnp.argmax(
        jnp.take_along_axis(logits, (jnp.asarray(lens) - 1)[:, None, None], 1)[:, 0],
        -1,
    ).astype(jnp.int32)
    pos = jnp.asarray(lens)
    step = jax.jit(lambda m, c, t, p: m(t, c, p))
    # warm
    logits, caches = step(model, caches, last[:, None], pos[:, None])
    np.asarray(logits)
    t0 = time.perf_counter()
    n = 0
    for _ in range(max_new - 1):
        logits, caches = step(model, caches, last[:, None], pos[:, None])
        last = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        pos = pos + 1
        n += b
    np.asarray(last)  # host-fetch barrier (block_until_ready lies here)
    dt = time.perf_counter() - t0
    return n / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="tiny", choices=["tiny", "small"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cfg = flagship_model_config(args.scale)
    target = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    cfg_tiny = flagship_model_config("tiny")
    tiny = QuantizedTransformer.init(jax.random.PRNGKey(7), cfg_tiny)

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(3, 10))).tolist()
        for _ in range(args.batch)
    ]

    results = {}
    plain = plain_tokens_per_s(target, cfg, prompts, args.max_new)
    results["plain"] = {"tokens_per_s": round(plain, 1)}
    print(f"plain decode loop: {plain:8.1f} tok/s")

    for name, draft, dcfg in (
        ("spec_self", target, cfg),
        ("spec_tiny_draft", tiny, cfg_tiny),
    ):
        if dcfg.vocab_size != cfg.vocab_size:
            continue
        dec = SpeculativeDecoder(target, draft, cfg, dcfg, gamma=args.gamma)
        # warm compile with the SAME max_seq (cache shapes key the jit)
        mseq = max(len(p) for p in prompts) + args.max_new + args.gamma + 2
        dec.generate(prompts, max_new_tokens=4, max_seq=mseq)
        t0 = time.perf_counter()
        out = dec.generate(prompts, max_new_tokens=args.max_new, max_seq=mseq)
        dt = time.perf_counter() - t0
        tot = sum(len(o) for o in out)
        results[name] = {
            "tokens_per_s": round(tot / dt, 1),
            "acceptance_rate": round(dec.stats.acceptance_rate, 3),
            "rounds": dec.stats.rounds,
            "gamma": args.gamma,
            "speedup_vs_plain": round((tot / dt) / plain, 2),
        }
        print(f"{name:<16} {tot/dt:8.1f} tok/s  accept="
              f"{dec.stats.acceptance_rate:.2f}  x{(tot/dt)/plain:.2f} vs plain")

    if args.json:
        import json

        doc = {
            "scale": args.scale, "batch": args.batch,
            "device": str(jax.devices()[0]),
            "note": "self-draft = mechanics upper bound (acceptance 1.0); "
                    "random tiny draft = lower bound (acceptance ~0; trained "
                    "pairs land between)",
            "results": results,
        }
        json.dump(doc, open(args.json, "w"), indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
