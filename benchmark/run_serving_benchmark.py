#!/usr/bin/env python
"""Serving-level throughput: continuous batching under a request stream.

Completes the benchmark family at the highest level of the stack: the
ServingEngine drains a queue of variable-length requests and reports
aggregate generated-tokens/s plus per-request latency stats (the engine is
host-driven, so host dispatch is part of every step).

Usage: python benchmark/run_serving_benchmark.py [--scale tiny] [--slots 4]
"""
import argparse
import sys
import time

import numpy as np

import _bootstrap  # noqa: F401
import jax

from fused4bit.models.config import flagship_model_config
from fused4bit.models.transformer import QuantizedTransformer
from fused4bit.serving.engine import GenerationRequest, ServingEngine


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="tiny", choices=["tiny", "small"])
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--mode", default="kernel",
                   choices=["kernel", "xla_turbo", "u4_turbo", "per_group"],
                   help="kernel = fused INT4 kernels; "
                        "xla_turbo = int8-resident XLA (ops/int8_xla); "
                        "u4_turbo = packed residency, transient-i8 prefill; "
                        "per_group = per_group(128) weights on the kernels")
    p.add_argument("--decode-block", type=int, default=1,
                   help="decode steps fused into one compiled dispatch "
                        "(lax.scan in-graph; amortizes host dispatch)")
    p.add_argument("--prefill-bucket", type=int, default=16)
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool (layers/paged_kv): the decode kernel "
                        "reads each tile's page from the table")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--num-pages", type=int, default=None,
                   help="pool size; default = contiguous-equivalent; set "
                        "lower to exercise admission control")
    p.add_argument("--spec-draft", default=None, choices=["self", "tiny"],
                   help="speculative continuous batching: draft = the target "
                        "itself (acceptance 1.0 upper bound) or an "
                        "independent tiny model (random-weights floor)")
    p.add_argument("--spec-gamma", type=int, default=4)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    cfg = flagship_model_config(args.scale)
    model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    if args.mode == "xla_turbo":
        from fused4bit.models.transformer import as_xla_turbo
        model = as_xla_turbo(model)
    elif args.mode == "u4_turbo":
        from fused4bit.models.transformer import as_u4_turbo
        model = as_u4_turbo(model)
    elif args.mode == "per_group":
        from fused4bit.models.transformer import as_per_group
        model = as_per_group(model, group_size=128)
    spec_kw = {}
    if args.spec_draft:
        if args.spec_draft == "self":
            draft, dcfg = model, cfg
        else:
            import dataclasses as _dc
            # draft must share the target's vocabulary
            dcfg = _dc.replace(
                flagship_model_config("tiny"), vocab_size=cfg.vocab_size
            )
            draft = QuantizedTransformer.init(jax.random.PRNGKey(7), dcfg)
        spec_kw = dict(draft_model=draft, draft_cfg=dcfg,
                       spec_gamma=args.spec_gamma)
        args.decode_block = 1
    eng = ServingEngine(
        model, cfg, num_slots=args.slots, max_seq=args.max_seq,
        prefill_bucket=args.prefill_bucket, decode_block=args.decode_block,
        paged=args.paged, page_size=args.page_size, num_pages=args.num_pages,
        **spec_kw,
    )
    rng = np.random.default_rng(0)
    total_new = 0
    for uid in range(args.requests):
        plen = int(rng.integers(3, 14))
        nnew = int(rng.integers(4, args.max_new))
        total_new += min(nnew, args.max_seq - 16 - 1)
        eng.submit(GenerationRequest(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=nnew,
        ))

    # warm compile: run one step so compile time is excluded; tokens it
    # produced are excluded from the timed count (a decode_block warm step
    # can emit up to block*slots tokens "for free" otherwise)
    eng.step()
    pre = sum(len(v) for v in eng.generated.values()) + sum(
        len(v) for v in eng.finished.values()
    )
    t0 = time.perf_counter()
    out = eng.run()
    dt = time.perf_counter() - t0

    produced = sum(len(v) for v in out.values()) - pre
    print(f"requests: {len(out)}  generated tokens: {produced}")
    print(f"wall: {dt:.2f}s -> {produced/dt:.1f} generated tokens/s "
          f"({args.slots} slots, {jax.default_backend()})")
    lens = sorted(len(v) for v in out.values())
    print(f"tokens/request: min {lens[0]} median {lens[len(lens)//2]} max {lens[-1]}")
    if args.json:
        import json, os
        data = {}
        if os.path.exists(args.json):
            data = json.load(open(args.json))
        key = args.mode if args.decode_block == 1 else (
            f"{args.mode}_d{args.decode_block}"
        )
        if args.paged:
            key += f"_paged{args.page_size}"
        if args.spec_draft:
            key += f"_spec_{args.spec_draft}_g{args.spec_gamma}"
            data_extra = {
                "acceptance_rate": round(eng.spec_stats.acceptance_rate, 3),
                "spec_rounds": eng.spec_stats.rounds,
            }
        else:
            data_extra = {}
        data[key] = {
            **data_extra,
            "generated_tokens_per_s": round(produced / dt, 1),
            "requests": len(out), "tokens": produced, "slots": args.slots,
            "decode_block": args.decode_block,
            "scale": args.scale, "backend": jax.default_backend(),
            "note": "decode_block>1 amortizes host dispatch in-graph "
                    "(lax.scan over decode steps)",
        }
        json.dump(data, open(args.json, "w"), indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
