#!/usr/bin/env python3
"""Smoke run of the INT4 Mixtral-8x7B serving path on an NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the DP x EP mesh only

Phases, all in this one process (a JAX process reserves most of the card):

1. The card: JAX's platform, device kind and count, and ``nvidia-smi``'s
   name and power limit. Every time printed below was taken on this card.
2. Each kernel at Mixtral-8x7B widths against the plain reference
   (dequantize, then a float32 product at HIGHEST precision): the INT4
   linear at decode M=8 (per_row and per_group128), the grouped MoE at T=8
   and T=2048 (8 experts, top-2), and attention over the INT4 cache at 1k
   and 8k context, contiguous and paged.
3. Each kernel against the plain version XLA compiles, at the same shapes:
   device time per call from a profiler trace (`utils.device_profile`),
   each call over enough distinct weights or caches that the 50 MB L2 cache
   cannot hold them.
4. ``ServingEngine`` over the full 32-layer model (random weights from a
   seed): 8 requests of 16-600 prompt tokens on 4 slots with chunked
   prefill, once with the contiguous INT4 cache and once paged, with bf16
   activations (the serving path) and again with float32 activations. The
   sampler hands each token's logits to the host. Paged and contiguous must
   give the same tokens and logits. Every run's logits at the prompt's last
   position and at the first decode step are held to the float32 reference
   forward's (`fused4bit.models.reference`), and the float32 runs' first
   tokens must be in the reference's top-2; see the bounds below
   `FOUR_CARD_LAYERS`.

``--four-cards`` runs only the mesh path: the engine over a mesh with all
four cards on the ``expert`` axis, against the one-card engine and against
mesh mode on one card, in this process (the same tokens, and logits at
every step within a bound), and the dropless EP strategy over
``ragged_all_to_all``.

The script exits non-zero if any phase fails, or if JAX finds no GPU. Its
last line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fused4bit import platform  # noqa: E402
from fused4bit.layers.kv_cache import QuantizedKVCache  # noqa: E402
from fused4bit.layers.moe import (  # noqa: E402
    dispatch, make_dispatch_plan, simulate_router_logits, topk_route,
)
from fused4bit.layers.paged_kv import PagedKVCache  # noqa: E402
from fused4bit.ops.decode_attention import (  # noqa: E402
    int4_decode_attention, int4_decode_attention_plain,
)
from fused4bit.ops.grouped_matmul import (  # noqa: E402
    grouped_int4_matmul, grouped_int4_matmul_plain,
)
from fused4bit.ops.int4_matmul import int4_matmul, int4_matmul_plain  # noqa: E402
from fused4bit.quant.core import QuantizedTensor, dequantize, quantize  # noqa: E402
from fused4bit.quant.reference import reference_linear_qt  # noqa: E402

_HI = jax.lax.Precision.HIGHEST

# Tolerances, as max|kernel - reference| / max|reference|:
# * INT4 matmuls: bf16 activations times integer (q - zp) are exact
#   products, summed in float32 in another order than the reference
#   (~1e-6 relative); the scale is applied to the float32 sum.
LINEAR_TOL = 1e-3
# * attention: the kernel rounds q, the dequantized K/V and the softmax
#   weights to bf16 (2**-9 relative each) before its dots, which accumulate
#   in float32.
ATTENTION_TOL = 2e-2


@dataclasses.dataclass(frozen=True)
class Widths:
    """Kernel shapes of phases 2 and 3 (Mixtral-8x7B by default)."""

    hidden: int = 4096
    ffn: int = 14336
    qkv: int = 6144
    vocab: int = 32000
    experts: int = 8
    top_k: int = 2
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    decode_m: int = 8
    moe_tokens: tuple = (8, 2048)
    contexts: tuple = (1024, 8192)
    slots: int = 8
    page: int = 128
    group_size: int = 128
    repeats: int = 5
    min_bytes: int = 256 << 20   # distinct operands per timed call


FAILURES: list = []


def report(name: str, err: float, tol: float, extra: str = "") -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    if not ok:
        FAILURES.append(name)
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: rel err {err:.3e} "
          f"(tol {tol:g}){extra}", flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def copies_for(nbytes: int, w: Widths) -> int:
    return int(min(16, max(2, math.ceil(w.min_bytes / max(nbytes, 1)))))


def time_call(fn, arg_sets, repeats: int) -> float:
    """Device seconds per call of ``fn``: the kernels' durations in a
    profiler trace of ``repeats`` dispatches, each of which runs ``fn`` over
    every set in ``arg_sets``, after a warm-up."""
    from fused4bit.utils.device_profile import device_op_times

    many = jax.jit(lambda sets: [fn(*a) for a in sets])
    jax.block_until_ready(many(arg_sets))

    def run():
        for _ in range(repeats):
            jax.block_until_ready(many(arg_sets))

    prof = device_op_times(run)
    return prof.total_ms / 1e3 / (repeats * len(arg_sets))


def print_times(name: str, t_kernel: float, t_plain: float) -> None:
    print(f"  time {name}: kernel {t_kernel * 1e6:.1f} us, plain XLA "
          f"{t_plain * 1e6:.1f} us ({t_plain / t_kernel:.2f}x), device time",
          flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def card_info() -> dict:
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {d.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    print(f"[1] nvidia-smi: {smi}", flush=True)
    print(f"[1] jax {jax.__version__}, compile cache "
          f"{platform.enable_compile_cache()}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


# ---------------------------------------------------------------------------
# phases 2 and 3: kernels
# ---------------------------------------------------------------------------


def _weights(key, shape, granularity, w: Widths, n: int):
    """n distinct quantized weights of ``shape``."""
    mk = jax.jit(lambda k: quantize(
        jax.random.normal(k, shape, jnp.float32), granularity=granularity,
        group_size=w.group_size,
        layout="planar_groups" if granularity == "per_group" else "planar",
    ))
    return [mk(k) for k in jax.random.split(key, n)]


def check_linear(w: Widths) -> None:
    print("[2/3] INT4 linear, decode M=%d" % w.decode_m, flush=True)
    shapes = {
        "up   %d->%d" % (w.hidden, w.ffn): (w.ffn, w.hidden),
        "down %d->%d" % (w.ffn, w.hidden): (w.hidden, w.ffn),
        "qkv  %d->%d" % (w.hidden, w.qkv): (w.qkv, w.hidden),
        "head %d->%d" % (w.hidden, w.vocab): (w.vocab, w.hidden),
    }
    key = jax.random.PRNGKey(1)
    for gran in ("per_row", "per_group"):
        for name, (n, k) in shapes.items():
            label = f"linear {gran} {name}"
            c = copies_for(n * k // 2, w)
            qts = _weights(jax.random.fold_in(key, n + k), (n, k), gran, w, c)
            x = jax.random.normal(key, (w.decode_m, k), jnp.float32)
            xb = x.astype(jnp.bfloat16)
            got = jax.jit(lambda a, q: int4_matmul(a, q, out_dtype=jnp.float32))(
                xb, qts[0])
            with jax.default_matmul_precision("highest"):
                want = jax.jit(reference_linear_qt)(xb.astype(jnp.float32), qts[0])
            report(label, rel_err(got, want), LINEAR_TOL)
            sets = [(xb, q) for q in qts]
            print_times(label, time_call(int4_matmul, sets, w.repeats),
                        time_call(int4_matmul_plain, sets, w.repeats))


def _expert(qt: QuantizedTensor, e):
    return dataclasses.replace(
        qt, packed=qt.packed[e], scales=qt.scales[e],
        zero_points=qt.zero_points[e], shape=tuple(qt.shape[1:]),
    )


def _grouped_reference(xs, gids, qt, tile_m):
    """float32 per-row product with the dequantized weight of each row's
    expert, one expert at a time."""
    row_e = jnp.repeat(gids, tile_m)
    xf = xs.astype(jnp.float32)

    def body(e, y):
        wd = dequantize(_expert(qt, e), dtype=jnp.float32)
        ye = jnp.dot(xf, wd.T, precision=_HI)
        return jnp.where((row_e == e)[:, None], ye, y)

    y0 = jnp.zeros((xs.shape[0], qt.out_dim), jnp.float32)
    return jax.lax.fori_loop(0, qt.shape[0], body, y0)


def check_grouped(w: Widths) -> None:
    print("[2/3] grouped MoE, %d experts top-%d" % (w.experts, w.top_k),
          flush=True)
    key = jax.random.PRNGKey(2)
    cases = []
    for t in w.moe_tokens:
        tile_m = 16 if t * w.top_k <= 512 else 128   # MoEBlock's choice
        cases.append((t, tile_m, "gate", (w.experts, w.ffn, w.hidden), "per_row"))
        cases.append((t, tile_m, "down", (w.experts, w.hidden, w.ffn), "per_row"))
        if t == w.moe_tokens[0]:
            cases.append((t, tile_m, "gate", (w.experts, w.ffn, w.hidden),
                          "per_group"))
    for t, tile_m, proj, shape, gran in cases:
        label = f"grouped {gran} {proj} T={t} tile_m={tile_m}"
        e, n, k = shape
        c = copies_for(e * n * k // 2, w)
        qts = _weights(jax.random.fold_in(key, n + t), shape, gran, w, c)
        logits = simulate_router_logits(jax.random.fold_in(key, t), t, e)
        routing = topk_route(logits, w.top_k, e)
        plan = make_dispatch_plan(routing, e, tile_m=tile_m)
        x = jax.random.normal(key, (t, k), jnp.float32).astype(jnp.bfloat16)
        xs = dispatch(x, routing, plan)
        gids = plan.tile_group_ids
        run = jax.jit(lambda a, g, q: grouped_int4_matmul(
            a, g, q, tile_m=tile_m, out_dtype=jnp.float32))
        got = run(xs, gids, qts[0])
        with jax.default_matmul_precision("highest"):
            want = jax.jit(_grouped_reference, static_argnums=3)(
                xs, gids, qts[0], tile_m)
        report(label, rel_err(got, want), LINEAR_TOL,
               f" (rows {xs.shape[0]}, tiles {gids.shape[0]})")
        sets = [(xs, gids, q) for q in qts]
        t_k = time_call(lambda a, g, q: grouped_int4_matmul(
            a, g, q, tile_m=tile_m), sets, w.repeats)
        t_p = time_call(lambda a, g, q: grouped_int4_matmul_plain(
            a, g, q, tile_m, jnp.bfloat16).astype(jnp.bfloat16),
            sets, w.repeats)
        print_times(label, t_k, t_p)


def _attention_reference(q, cache):
    """float32 attention over the dequantized cache, length mask only."""
    k, v = cache.dequantize(dtype=jnp.float32)          # [B, Hkv, S, D]
    b, hq, d = q.shape
    g = hq // k.shape[1]
    qf = q.astype(jnp.float32).reshape(b, k.shape[1], g, d)
    s = jnp.einsum("bhgd,bhsd->bhgs", qf, k, precision=_HI) * d ** -0.5
    ok = jnp.arange(k.shape[2])[None, :] < cache.lengths[:, None]
    s = jnp.where(ok[:, None, None, :], s, -jnp.inf)
    o = jnp.einsum("bhgs,bhsd->bhgd", jax.nn.softmax(s, axis=-1), v,
                   precision=_HI)
    return o.reshape(b, hq, d)


def _caches(key, w: Widths, ctx: int):
    """A contiguous cache of random K/V at per-slot lengths up to ``ctx``,
    and a paged cache holding the same bytes under a shuffled page table."""
    b, h, d, page = w.slots, w.kv_heads, w.head_dim, w.page
    kk, kv, kl = jax.random.split(key, 3)
    k = jax.random.normal(kk, (b, h, ctx, d), jnp.float32)
    v = jax.random.normal(kv, (b, h, ctx, d), jnp.float32)
    cont = QuantizedKVCache.init(b, h, ctx, d).append(
        k, v, start=jnp.zeros((b,), jnp.int32))
    lengths = jnp.asarray(
        np.linspace(ctx // 2 + 1, ctx, b).astype(np.int32))
    cont = dataclasses.replace(cont, lengths=lengths)
    mp = ctx // page
    perm = np.asarray(jax.random.permutation(kl, b * mp)) + 1   # page 0 parked
    table = jnp.asarray(perm.reshape(b, mp), jnp.int32)

    def pool(a, per_page):   # [B, H, mp*per_page, ...] -> [1 + B*mp, H, per_page, ...]
        rest = a.shape[3:]
        a = a.reshape(b, h, mp, per_page, *rest).swapaxes(1, 2)
        a = a.reshape(b * mp, h, per_page, *rest)
        out = jnp.zeros((1 + b * mp,) + a.shape[1:], a.dtype)
        return out.at[table.reshape(-1)].set(a)

    paged = PagedKVCache(
        k_pool=pool(cont.k_packed, page // 2), v_pool=pool(cont.v_packed, page // 2),
        k_scale=pool(cont.k_scale, page), k_zp=pool(cont.k_zp, page),
        v_scale=pool(cont.v_scale, page), v_zp=pool(cont.v_zp, page),
        page_table=table, lengths=lengths,
    )
    return cont, paged


def check_attention(w: Widths) -> None:
    print("[2/3] decode attention over the INT4 cache, %d slots, %d/%d heads"
          % (w.slots, w.heads, w.kv_heads), flush=True)
    key = jax.random.PRNGKey(3)
    for ctx in w.contexts:
        nbytes = 2 * w.slots * w.kv_heads * ctx * (w.head_dim // 2 + 8)
        c = copies_for(nbytes, w)
        pairs = [_caches(jax.random.fold_in(key, ctx + i), w, ctx)
                 for i in range(c)]
        q = jax.random.normal(key, (w.slots, w.heads, w.head_dim),
                              jnp.float32).astype(jnp.bfloat16)
        with jax.default_matmul_precision("highest"):
            want = jax.jit(_attention_reference)(q, pairs[0][0])
        for kind, idx in (("contiguous", 0), ("paged", 1)):
            label = f"attention {kind} ctx={ctx}"
            got = jax.jit(lambda a, cc: int4_decode_attention(
                a, cc, out_dtype=jnp.float32))(q, pairs[0][idx])
            report(label, rel_err(got, want), ATTENTION_TOL)
            sets = [(q, p[idx]) for p in pairs]
            print_times(label,
                        time_call(int4_decode_attention, sets, w.repeats),
                        time_call(int4_decode_attention_plain, sets,
                                  w.repeats))


# ---------------------------------------------------------------------------
# phase 4: the engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (16, 600, 77, 300, 33, 512, 128, 450)
NEW_TOKENS = 8
SEED = 0
# The mesh check runs Mixtral-8x7B's full widths at 2 of its 32 layers: the
# mesh path is the same for every layer, and four cards cost four times as
# much per second.
FOUR_CARD_LAYERS = 2

# Bounds on an engine's logits against the float32 reference, as
# rms|engine - reference| / rms|reference| over the vocabulary (`rms_err`:
# sqrt(2) for unrelated logits, so a broken kernel or cache lands near 1.4).
# * float32 activations at 2 layers: the products match the reference up to
#   the order of float32 sums (1e-6 on the CPU at tiny width), but at full
#   width a last-bit difference can still flip a K/V rounding level (on the
#   H100 the one-card and mesh engines, whose prefills differ only in batch
#   shape, parted by up to 4.3e-3), and at a decode step the attention
#   kernel rounds q, K/V and the softmax weights to bf16 (2**-9 relative).
SHALLOW_LAYERS = 2
SHALLOW_LOGIT_TOL = 5e-2
# * float32 activations at 32 layers: random-weight layers amplify last-bit
#   differences (on the CPU, the same model at tiny width goes from 1e-6 at
#   2 layers to 5e-4-3e-3 at 32), and a difference that flips a top-2
#   expert choice or a K/V rounding level moves a token's state by much more
#   (7% at one CPU position). Measured on the H100: 1.6e-2 to 0.17 at the
#   prompt's last position, 1.5e-2 to 0.14 at the first decode step.
DEEP_F32_LOGIT_TOL = 0.35
# * bf16 activations at 32 layers: every layer's input is rounded to bf16,
#   and flips are as many as the roundings make; held on the median of the
#   8 requests (measured on the H100: 0.25, worst 0.54), since a flip puts
#   one request far off while a broken path moves every request.
BF16_LOGIT_TOL = 0.5
# * the same engine through another layout (paged against contiguous, the
#   DP x EP mesh against one card): the same blocks on the same rows (kernel
#   blocks do not follow a launch's m-block count) and a psum that adds
#   exact zeros, so the logits should agree bit for bit; the bound admits
#   float32 summation order only. (On the H100 the mesh on 4 cards matched
#   mesh mode on 1 card bit for bit and the one-card engine, whose prefill
#   runs one slot at a time, to 4.3e-3.)
SAME_LOGITS_TOL = 1e-5


def _prompts(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in PROMPT_LENS]


def init_model(cfg, seed: int, dtype=jnp.bfloat16):
    from fused4bit.models.transformer import QuantizedTransformer

    t0 = time.perf_counter()
    model = QuantizedTransformer.init(jax.random.PRNGKey(seed), cfg, dtype=dtype)
    jax.block_until_ready(model)
    print(f"[4] model {cfg.name} ({jnp.dtype(dtype).name} activations): "
          f"{cfg.num_layers} layers, {model.nbytes / 1e9:.2f} GB on device, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    return model


@dataclasses.dataclass
class Served:
    """What one engine run gave: tokens, and the logits each token was
    chosen from ([V] float32 per step)."""

    tokens: dict
    logits: dict


def serve(model, cfg, prompts, *, new_tokens: int, label: str, **engine_kw):
    """Run the engine over ``prompts`` with greedy sampling; returns
    (Served, engine). The sampler hands each logits batch to the host, so
    every token's logits row is kept."""
    from fused4bit.serving.engine import GenerationRequest, Sampler, ServingEngine

    @dataclasses.dataclass(frozen=True)
    class LogitsTap(Sampler):
        sink: list = dataclasses.field(default_factory=list, compare=False)

        def sample(self, logits, key):
            jax.debug.callback(lambda a: self.sink.append(np.asarray(a)), logits)
            return super().sample(logits, key)

    tap = LogitsTap()
    logits = {u: [] for u in range(len(prompts))}
    engine = []

    def on_token(uid, tok, lp):
        jax.effects_barrier()
        rows = tap.sink[-1]
        if rows.shape[0] == 1:           # the prompt's last position
            row = rows[0]
        else:                            # a decode step over every slot
            row = rows[next(s for s, r in engine[0].active.items() if r.uid == uid)]
        if int(np.argmax(row)) != tok:
            raise AssertionError(f"request {uid}: token {tok} is not the "
                                 "argmax of the logits kept for it")
        logits[uid].append(np.asarray(row, np.float32))

    eng = ServingEngine(model, cfg, num_slots=4, max_seq=1024,
                        prefill_bucket=64, sampler=tap, on_token=on_token,
                        **engine_kw)
    engine.append(eng)
    for uid, p in enumerate(prompts):
        eng.submit(GenerationRequest(uid=uid, prompt=p,
                                     max_new_tokens=new_tokens))
    t0 = time.perf_counter()
    eng.step()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = 1
    while eng.active or eng.queue:
        eng.step()
        steps += 1
    t_rest = time.perf_counter() - t0
    out = Served(dict(eng.finished), logits)
    n_tok = sum(len(v) for v in out.tokens.values())
    print(f"[4] engine {label}: {len(out.tokens)} requests, {n_tok} tokens, "
          f"{steps} steps; first step (compiles prefill and decode) "
          f"{t_first:.1f} s, remaining steps {t_rest:.2f} s", flush=True)
    return out, eng


def reference_logits_at(model, seqs, positions) -> np.ndarray:
    """float32 reference logits [P, S, V] of each sequence at each of its
    ``positions`` (S per sequence)."""
    from fused4bit.models.reference import reference_logits

    t_pad = -(-max(len(s) for s in seqs) // 64) * 64
    toks = np.zeros((len(seqs), t_pad), np.int32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        logits = reference_logits(model, jnp.asarray(toks))
    out = np.stack([np.asarray(logits[i, np.asarray(p)])
                    for i, p in enumerate(positions)])
    print(f"[4] float32 reference forward: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def rms_err(got, want) -> float:
    """rms|got - want| / rms|want|: sqrt(2) for unrelated logits of one
    scale, 0 for equal ones."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def check_against_reference(run: Served, ref, ref_tok0, label: str,
                            tol: float, reduce=max, top: int = 0) -> None:
    """The run's logits at the prompt's last position (step 0) and at the
    first decode step (step 1) against the reference's: the ``reduce``
    (max or median) over the requests of `rms_err` must not pass ``tol``.
    Step 1 is compared only where the run chose the token the reference was
    fed (``ref_tok0``). With ``top``, each first token must also rank below
    ``top`` in the reference."""
    n = len(ref)
    ranks = [int(np.sum(ref[i, 0] > ref[i, 0][run.tokens[i][0]]))
             for i in range(n)]
    for step in (0, 1):
        idx = [i for i in range(n) if step == 0 or (
            run.tokens[i][0] == ref_tok0[i] and len(run.logits[i]) > 1)]
        if not idx:
            continue
        got = [run.logits[i][step] for i in idx]
        rms = [rms_err(g, ref[i, step]) for g, i in zip(got, idx)]
        report(f"{label}: {'decode-step' if step else 'step-0'} logits against "
               f"the reference ({reduce.__name__} of {len(idx)} requests' rms)",
               float(reduce(rms)), tol)
        print(f"    rms rel err per request: {[float(f'{e:.3g}') for e in rms]}; "
              "max-abs rel err: "
              f"{[float(f'{rel_err(g, ref[i, step]):.3g}') for g, i in zip(got, idx)]}",
              flush=True)
    print(f"    first-token ranks in the reference: {ranks}", flush=True)
    if top:
        ok = all(r < top for r in ranks)
        if not ok:
            FAILURES.append(f"first tokens {label}")
        print(f"  {'ok  ' if ok else 'FAIL'} first tokens in the reference's "
              f"top-{top} ({label}): ranks {ranks}", flush=True)


def memory_report(eng) -> None:
    b = eng.num_slots
    z = jnp.zeros((b,), jnp.int32)
    compiled = eng._decode.lower(
        eng.model, eng.caches, z, z, jax.random.PRNGKey(0),
        jnp.zeros((b,), bool)).compile()
    print(f"[4] decode step memory_analysis: {compiled.memory_analysis()}",
          flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[4] peak_bytes_in_use: {stats.get('peak_bytes_in_use')}",
          flush=True)


def compare_runs(a: Served, b: Served, label: str, tol: float) -> None:
    """Two runs of the same prompts must give the same tokens, and logits
    within ``tol`` at every step up to the first token that differs."""
    same = all(a.tokens[u] == b.tokens[u] for u in a.tokens)
    if not same:
        FAILURES.append(f"{label}: tokens")
    print(f"  {'ok  ' if same else 'FAIL'} {label}: tokens equal for "
          f"{sum(a.tokens[u] == b.tokens[u] for u in a.tokens)}/{len(a.tokens)}"
          " requests", flush=True)
    errs, steps, exact = [], 0, True
    for u in a.tokens:
        for s, (ra, rb) in enumerate(zip(a.logits[u], b.logits[u])):
            errs.append(rel_err(rb, ra))
            exact &= bool(np.array_equal(ra, rb))
            steps += 1
            if a.tokens[u][s] != b.tokens[u][s]:
                break
    report(f"{label}: logits at {steps} steps", max(errs), tol,
           " (bit for bit equal)" if exact else "")
    for u in sorted(a.tokens):
        if a.tokens[u] != b.tokens[u]:
            print(f"    request {u}: {a.tokens[u]} | {b.tokens[u]}")


def check_float32(cfg, prompts, tol: float):
    """The engine with float32 activations over ``cfg`` (contiguous, 2 new
    tokens) against the float32 reference: logits within ``tol`` at both
    steps, first tokens in the reference's top-2. Returns the reference's
    logits [P, 2, V] and the first tokens it was fed.

    The reference (`fused4bit.models.reference`) reads each prompt followed
    by this run's first token, so its logits at the prompt's last position
    and at the next are those of the engine's first token (prefill) and
    second (the first decode step)."""
    model = init_model(cfg, SEED, dtype=jnp.float32)
    label = f"float32, {cfg.num_layers} layers"
    with jax.default_matmul_precision("highest"):
        run, eng = serve(model, cfg, prompts, new_tokens=2, label=label)
    del eng
    tok0 = [run.tokens[i][0] for i in range(len(prompts))]
    ref = reference_logits_at(
        model, [p + [t] for p, t in zip(prompts, tok0)],
        [(len(p) - 1, len(p)) for p in prompts])
    del model
    top2 = np.sort(ref[:, 0], axis=-1)[:, ::-1]
    print(f"    reference step 0: top-1 minus top-2 logit "
          f"{[float(f'{g:.3g}') for g in top2[:, 0] - top2[:, 1]]}, "
          f"max |logit| {[float(f'{m:.3g}') for m in np.abs(ref[:, 0]).max(-1)]}",
          flush=True)
    check_against_reference(run, ref, tok0, label, tol, top=2)
    return ref, tok0


def check_engine() -> None:
    """The serving path (bf16 activations) over the full model, contiguous
    then paged: the same tokens and logits, held to the float32 reference's
    logits. The same engine with float32 activations over the full model,
    and over its first 2 layers, where nothing amplifies a last-bit
    difference (`check_float32`)."""
    from fused4bit.models.config import flagship_model_config

    cfg = flagship_model_config("full")
    prompts = _prompts(cfg.vocab_size, SEED)
    model = init_model(cfg, SEED)
    cont, eng = serve(model, cfg, prompts, new_tokens=NEW_TOKENS,
                      label="bf16, contiguous")
    memory_report(eng)
    del eng
    paged, eng = serve(model, cfg, prompts, new_tokens=NEW_TOKENS,
                       label="bf16, paged", paged=True, page_size=128)
    del eng, model
    compare_runs(cont, paged, "bf16 paged against contiguous", SAME_LOGITS_TOL)
    for u in sorted(cont.tokens):
        print(f"    request {u} (prompt {len(prompts[u])}): {cont.tokens[u]}")

    ref, tok0 = check_float32(cfg, prompts, DEEP_F32_LOGIT_TOL)
    for run, label in ((cont, "bf16, contiguous"), (paged, "bf16, paged")):
        check_against_reference(run, ref, tok0, label, BF16_LOGIT_TOL,
                                reduce=np.median)
    check_float32(dataclasses.replace(cfg, num_layers=SHALLOW_LAYERS), prompts,
                  SHALLOW_LOGIT_TOL)


# ---------------------------------------------------------------------------
# --four-cards: the DP x EP mesh
# ---------------------------------------------------------------------------


def _moe_reference(x, logits, qt, top_k):
    """float32 MoE layer: every expert on every token, gated by top-k."""
    from fused4bit.models.reference import _gates

    wd = dequantize(qt, dtype=jnp.float32)
    y = jnp.einsum("tk,enk->etn", x.astype(jnp.float32), wd, precision=_HI)
    return jnp.einsum("te,etn->tn", _gates(logits, top_k), y, precision=_HI)


def check_ragged_ep(w: Widths, devices) -> None:
    from fused4bit.parallel.expert_parallel import moe_ep_a2a_dropless
    from fused4bit.parallel.mesh import make_mesh
    from fused4bit.parallel.sharding import shard_qt_experts

    n = len(devices)
    mesh = make_mesh(("expert",), (n,), devices=devices)
    key = jax.random.PRNGKey(4)
    t = 64 * n
    wts = jax.random.normal(key, (w.experts, w.ffn, w.hidden), jnp.float32)
    qt = quantize(wts, layout="planar")
    del wts
    x = jax.random.normal(key, (t, w.hidden), jnp.float32).astype(jnp.bfloat16)
    logits = simulate_router_logits(key, t, w.experts)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(_moe_reference, static_argnums=3)(x, logits, qt, w.top_k)
    qs = shard_qt_experts(qt, mesh, "expert")
    print(f"[4c] ragged_all_to_all native on {devices[0].platform}: "
          f"{platform.native_ragged_all_to_all()}", flush=True)
    got = jax.jit(lambda a, lg, q: moe_ep_a2a_dropless(
        a, lg, q, mesh, top_k=w.top_k, axis="expert"))(x, logits, qs)
    report(f"EP dropless ragged all-to-all over {n} cards, T={t}",
           rel_err(got.astype(jnp.float32), want), 1e-2,
           " (bf16 output)")


def check_four_cards() -> None:
    """The DP x EP mesh engine on 4 cards against the one-card engine, in
    this process, with float32 activations at HIGHEST precision: the same
    greedy tokens for every request, and the same logits at every step.

    The same engine in mesh mode over one card is run as well. The one-card
    engine prefills one slot at a time; mesh mode prefills the whole batch
    through the sharded step. Against both, a difference is located: in the
    engine's two prefill modes, or in the sharding of the experts."""
    from fused4bit.models.config import flagship_model_config
    from fused4bit.parallel.mesh import make_mesh
    from fused4bit.parallel.sharded_model import place_model

    devices = jax.devices()
    if len(devices) < 4:
        print(f"--four-cards needs 4 devices, found {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    devices = devices[:4]
    check_ragged_ep(Widths(), devices)
    cfg = dataclasses.replace(flagship_model_config("full"),
                              num_layers=FOUR_CARD_LAYERS)
    prompts = _prompts(cfg.vocab_size, SEED)
    model = init_model(cfg, SEED, dtype=jnp.float32)
    runs = {}
    with jax.default_matmul_precision("highest"):
        runs["one card"], _ = serve(model, cfg, prompts, new_tokens=NEW_TOKENS,
                                    label="one card")
        for n in (1, 4):
            mesh = make_mesh(devices=devices[:n])
            print(f"[4c] mesh {dict(mesh.shape)}", flush=True)
            runs[n], _ = serve(place_model(model, mesh), cfg, prompts,
                               new_tokens=NEW_TOKENS, mesh=mesh,
                               label=f"DP x EP mesh, {n} card(s)")
    compare_runs(runs["one card"], runs[4],
                 "mesh on 4 cards against the one-card engine", SAME_LOGITS_TOL)
    compare_runs(runs[1], runs[4],
                 "mesh on 4 cards against mesh mode on 1 card", SAME_LOGITS_TOL)
    for u in sorted(runs[4].tokens):
        print(f"    request {u}: {runs[4].tokens[u]}")


# ---------------------------------------------------------------------------


def phase(fn, *args) -> None:
    """Run one phase; an exception fails it, and the next phase still runs."""
    try:
        fn(*args)
    except Exception:
        traceback.print_exc()
        FAILURES.append(f"{fn.__name__} raised")
        print(f"  FAIL {fn.__name__} raised (traceback on stderr)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card DP x EP mesh path")
    args = ap.parse_args(argv)

    device = card_info()
    t0 = time.perf_counter()
    if args.four_cards:
        phase(check_four_cards)
    else:
        w = Widths()
        phase(check_linear, w)
        phase(check_grouped, w)
        phase(check_attention, w)
        phase(check_engine)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
