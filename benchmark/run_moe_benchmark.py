#!/usr/bin/env python
"""MoE grouped-GEMM benchmark CLI (reference parity).

Counterpart of the reference's `benchmark/run_moe_benchmark.py`
(argparse CLI at `:383-400`, implementation orchestration at `:67-272`).
Implementations compared, mirroring the reference's five
(naive loop / padded bmm / "triton" / INT4 / FP4):

  naive    — per-expert dense bf16 matmul, static per-expert capacity slices
             (`naive_grouped_gemm.py:34-41` analogue)
  bmm      — single capacity-padded batched einsum over all experts
             (`grouped_gemm_torch.py:48-100` analogue)
  int4     — fused grouped INT4 kernel (the product)
  int4-ref — dequantize-then-matmul INT4 (golden, `moe_int4_module.py:63-72`)

Unlike the reference, `--verify` actually verifies (the reference's
verify_correctness helper is never called, SURVEY.md §4).

Usage:
  python benchmark/run_moe_benchmark.py --config mixtral --tokens 128
  python benchmark/run_moe_benchmark.py --config debug --full
"""
import argparse
import json
import sys

import numpy as np

import _bootstrap  # noqa: F401  (repo-root import shim)
import jax
import jax.numpy as jnp

from fused4bit.layers.moe import (
    dispatch,
    combine,
    make_dispatch_plan,
    simulate_router_logits,
    topk_route,
)
from fused4bit.models.config import get_config_by_name
from fused4bit.ops.grouped_matmul import grouped_int4_matmul
from fused4bit.quant import dequantize, quantize
from fused4bit.utils.benchmark import BenchmarkResult, print_table, time_fn_scan


def build(cfg, num_tokens, distribution, tile_m, seed=0):
    rng = np.random.default_rng(seed)
    E, K, N = cfg.num_experts, cfg.hidden_dim, cfg.ffn_dim
    w = jnp.asarray(rng.standard_normal((E, N, K)) * 0.02, dtype=jnp.float32)
    qt = jax.block_until_ready(jax.jit(lambda a: quantize(a, layout="planar"))(w))
    wb = w.astype(jnp.bfloat16)
    from fused4bit.quant.fp4 import quantize_fp4
    fp4 = jax.block_until_ready(jax.jit(quantize_fp4)(w))
    x = jnp.asarray(rng.standard_normal((num_tokens, K)), dtype=jnp.bfloat16)
    logits = simulate_router_logits(jax.random.PRNGKey(seed), num_tokens, E, distribution)
    routing = topk_route(logits, cfg.top_k, E)
    plan = make_dispatch_plan(routing, E, tile_m=tile_m)
    xs = dispatch(x, routing, plan)
    return dict(w=w, qt=qt, wb=wb, fp4=fp4, x=x, routing=routing, plan=plan,
                xs=xs, E=E, K=K, N=N, cap=plan.t_pad // E)


def implementations(env, tile_m):
    """name -> (fn(xs, *consts), consts). Weights travel as jit arguments —
    closures lower to literal HLO constants."""
    E, K, N, cap = env["E"], env["K"], env["N"], env["cap"]
    wb, qt, plan = env["wb"], env["qt"], env["plan"]
    gids = plan.tile_group_ids

    def naive(xs, w):
        # Per-expert loop over capacity slices (static), like the reference's
        # python for-loop baseline.
        outs = []
        for e in range(E):
            xe = jax.lax.dynamic_slice_in_dim(xs, e * cap, cap, 0)
            outs.append(xe @ w[e].T)
        return jnp.concatenate(outs, axis=0)

    def bmm(xs, w):
        xp = xs[: E * cap].reshape(E, cap, K)
        return jnp.einsum("eck,enk->ecn", xp, w).reshape(-1, N)

    def int4(xs, q):
        return grouped_int4_matmul(xs, gids, q, tile_m=tile_m)

    def int4_ref(xs, q):
        wd = dequantize(q, dtype=jnp.bfloat16)
        xp = xs[: E * cap].reshape(E, cap, K)
        return jnp.einsum("eck,enk->ecn", xp, wd).reshape(-1, N)

    def fp4(xs, f):
        # emulated E2M1 path (reference grouped_gemm_fp4.py analogue)
        from fused4bit.quant.fp4 import dequantize_fp4
        wd = dequantize_fp4(f, dtype=jnp.bfloat16)
        xp = xs[: E * cap].reshape(E, cap, K)
        return jnp.einsum("eck,enk->ecn", xp, wd).reshape(-1, N)

    return {"naive": (naive, (wb,)), "bmm": (bmm, (wb,)),
            "int4": (int4, (qt,)), "int4-ref": (int4_ref, (qt,)),
            "fp4": (fp4, (env["fp4"],))}


def run_once(cfg, num_tokens, distribution, warmup, iters, tile_m, verify, impls_filter):
    env = build(cfg, num_tokens, distribution, tile_m)
    impls = implementations(env, tile_m)
    if impls_filter:
        impls = {k: v for k, v in impls.items() if k in impls_filter}
    xs = env["xs"]
    results = []
    outputs = {}
    for name, (fn, consts) in impls.items():
        try:
            t = time_fn_scan(
                fn, xs, consts=consts, warmup=min(warmup, 2),
                iters=min(iters, 10), repeats=4,
            )
        except Exception as exc:  # graceful feature flags, ref :67-97
            print(f"  [skip] {name}: {type(exc).__name__}: {str(exc)[:120]}")
            continue
        outputs[name] = jax.jit(fn)(xs, *consts)
        results.append(
            BenchmarkResult(
                name, t * 1e3, num_tokens=num_tokens,
                extra={"weight_MB": (env["qt"].nbytes if "int4" in name
                                     else env["wb"].size * 2) / 1e6},
            )
        )
    print(f"\n=== {cfg.name}: E={cfg.num_experts} {cfg.hidden_dim}->{cfg.ffn_dim} "
          f"top{cfg.top_k}, T={num_tokens}, dist={distribution} ===")
    base = "naive" if any(r.name == "naive" for r in results) else results[0].name
    print_table(results, baseline=base)
    print(f"weights: bf16 {env['wb'].size*2/1e6:.0f} MB -> int4 {env['qt'].nbytes/1e6:.0f} MB")

    if verify and "int4" in outputs:
        got = combine(outputs["int4"], env["routing"], env["plan"])
        wd = dequantize(env["qt"], dtype=jnp.float32)
        # all-experts outputs then gather: avoids the [T,k,N,K] weight gather
        # (56 GB at Mixtral scale)
        all_out = jnp.einsum("th,enh->ten", env["x"].astype(jnp.float32), wd)
        sel = jnp.take_along_axis(
            all_out, env["routing"].expert_indices[..., None], axis=1
        )  # [T, k, N]
        want = jnp.sum(
            sel * env["routing"].expert_weights[..., None], axis=1
        )
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
        rel = err / float(jnp.max(jnp.abs(want)))
        status = "OK" if rel < 2e-2 else "FAIL"
        print(f"verify vs dense dequant reference: max abs {err:.4f} (rel {rel:.4f}) {status}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="mixtral")
    p.add_argument("--tokens", type=int, default=128)
    p.add_argument("--distribution", default="uniform",
                   choices=["uniform", "skewed", "random"])
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--tile-m", type=int, default=16)
    p.add_argument("--full", action="store_true",
                   help="sweep token counts 128/512/2048 (ref :275-301)")
    p.add_argument("--verify", action="store_true", default=True)
    p.add_argument("--no-verify", dest="verify", action="store_false")
    p.add_argument("--impls", nargs="*", default=None,
                   help="subset of naive/bmm/int4/int4-ref")
    p.add_argument("--output", default=None, help="write results JSON here")
    p.add_argument("--plot", default=None,
                   help="write a latency/speedup PNG here (reference parity: "
                        "run_moe_benchmark.py:304-380 plots)")
    args = p.parse_args(argv)

    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    cfg = get_config_by_name(args.config)
    sweeps = [128, 512, 2048] if args.full else [args.tokens]
    all_results = {}
    for t in sweeps:
        res = run_once(cfg, t, args.distribution, args.warmup, args.iters,
                       args.tile_m, args.verify, args.impls)
        all_results[t] = {r.name: r.mean_ms for r in res}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(all_results, f, indent=2)
        print(f"wrote {args.output}")
    if args.plot:
        plot_results(all_results, cfg, args.plot)
    return 0


def plot_results(all_results, cfg, path):
    """Latency + speedup bar charts (reference plot parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tokens = sorted(all_results)
    impls = sorted({k for r in all_results.values() for k in r})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    width = 0.8 / max(len(impls), 1)
    for i, name in enumerate(impls):
        xs_ = range(len(tokens))
        ys = [all_results[t].get(name, float("nan")) for t in tokens]
        ax1.bar([x + i * width for x in xs_], ys, width, label=name)
        base = [all_results[t].get("naive") or all_results[t].get("bmm")
                for t in tokens]
        sp = [b / y if (b and y) else float("nan") for b, y in zip(base, ys)]
        ax2.bar([x + i * width for x in xs_], sp, width, label=name)
    for ax, ylab in ((ax1, "latency (ms)"), (ax2, "speedup vs baseline")):
        ax.set_xticks([x + 0.4 for x in range(len(tokens))])
        ax.set_xticklabels([str(t) for t in tokens])
        ax.set_xlabel("tokens")
        ax.set_ylabel(ylab)
        ax.legend(fontsize=8)
    fig.suptitle(f"MoE grouped GEMM — {cfg.name}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
