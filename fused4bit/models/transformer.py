"""Mixtral-style INT4 decoder model (the flagship serving slice).

The reference ships no model — only the quantized linear / MoE layer
primitives plus Mixtral-8x7B *geometry* constants
(`benchmark/moe_grouped_gemm/config.py:70-77`,
`python/moe_int4_module.py:159-165`). This module assembles those primitives
into the decode model the reference's README markets (INT4 weight-only
inference): GQA attention with RoPE and an INT4 KV cache, SwiGLU MoE blocks
on the grouped INT4 kernel, RMSNorm, all projections as `QuantizedLinear`.

Everything is a frozen pytree dataclass: jit/vmap/shard/checkpoint friendly.
Weights live packed INT4 in device memory end to end.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..layers.kv_cache import QuantizedKVCache
from ..layers.linear import QuantizedLinear
from ..layers.moe import (
    MoEINT4,
    combine,
    dispatch,
    make_dispatch_plan,
    topk_route,
)
from .config import ModelConfig

__all__ = [
    "QuantizedTransformer", "TransformerBlock", "MoEBlock", "Attention",
    "as_xla_turbo", "as_u4_turbo", "as_per_group",
]


# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------


def rms_norm(x: jnp.ndarray, gamma: jnp.ndarray, eps: float) -> jnp.ndarray:
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    return (x.astype(jnp.float32) * jax.lax.rsqrt(var + eps)).astype(x.dtype) * gamma


def rotary_embedding(x: jnp.ndarray, positions: jnp.ndarray, theta: float):
    """RoPE over [B, H, T, D] (half-split convention).

    positions: [T] (shared across the batch) or [B, T] (per-slot, as in
    continuous batching where every sequence is at a different offset).
    """
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    if positions.ndim == 1:
        angles = positions[:, None].astype(jnp.float32) * freqs[None, :]  # [T, half]
    else:
        # [B, 1, T, half] to broadcast over heads
        angles = positions[:, None, :, None].astype(jnp.float32) * freqs
    cos, sin = jnp.cos(angles), jnp.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
    )
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + INT4 KV cache)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Attention:
    wq: QuantizedLinear
    wk: QuantizedLinear
    wv: QuantizedLinear
    wo: QuantizedLinear
    num_heads: int = dataclasses.field(metadata=dict(static=True))
    num_kv_heads: int = dataclasses.field(metadata=dict(static=True))
    head_dim: int = dataclasses.field(metadata=dict(static=True))
    rope_theta: float = dataclasses.field(metadata=dict(static=True))
    use_fused_attention: bool = dataclasses.field(
        metadata=dict(static=True), default=True
    )

    @classmethod
    def init(cls, key, cfg: ModelConfig, hidden: int):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        return cls(
            wq=QuantizedLinear.init(k1, hidden, nh * hd),
            wk=QuantizedLinear.init(k2, hidden, nkv * hd),
            wv=QuantizedLinear.init(k3, hidden, nkv * hd),
            wo=QuantizedLinear.init(k4, nh * hd, hidden),
            num_heads=nh, num_kv_heads=nkv, head_dim=hd,
            rope_theta=cfg.rope_theta,
        )

    def __call__(
        self,
        x: jnp.ndarray,                  # [B, T, H]
        cache: QuantizedKVCache,
        positions: jnp.ndarray,          # [B, T] (per-slot offsets)
    ) -> Tuple[jnp.ndarray, QuantizedKVCache]:
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim

        q = self.wq(x).reshape(b, t, nh, hd).transpose(0, 2, 1, 3)
        k = self.wk(x).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
        v = self.wv(x).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)

        q = rotary_embedding(q, positions, self.rope_theta)
        k = rotary_embedding(k, positions, self.rope_theta)

        # Cache index == sequence position: row b writes at positions[b, 0].
        cache = cache.append(k, v, start=positions[:, 0])

        # The jnp path below is the golden/debug path
        # (use_fused_attention=False).
        if self.use_fused_attention:
            # Decode reads the packed INT4 cache in the kernel; prefill
            # dequantizes the slot's cache for XLA's attention. Correct when
            # each row's history is contiguous below its length and this
            # call's writes are the most recent entries (positions[:, 0] ==
            # previous length).
            if t == 1:
                from ..ops.decode_attention import int4_decode_attention

                out = int4_decode_attention(q[:, :, 0, :], cache)  # [B, nh, D]
            else:
                from ..ops.decode_attention import int4_prefill_attention

                out4 = int4_prefill_attention(q, cache, positions[:, 0])
                out = out4.transpose(0, 2, 1, 3)  # [B, T, nh, D]
            out = out.reshape(b, t, nh * hd)
            return self.wo(out), cache

        kd, vd = cache.dequantize(dtype=q.dtype)  # [B, nkv, S, D]

        # GQA: repeat kv heads to match query heads.
        rep = nh // nkv
        kd = jnp.repeat(kd, rep, axis=1)
        vd = jnp.repeat(vd, rep, axis=1)

        scores = jnp.einsum("bhtd,bhsd->bhts", q, kd) / jnp.sqrt(float(hd))
        s_max = cache.max_seq
        span = jnp.arange(s_max)[None, None, :]            # [1, 1, S]
        causal = span <= positions[:, :, None]             # [B, T, S]
        scores = jnp.where(
            causal[:, None], scores.astype(jnp.float32), -1e30
        )
        probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
        out = jnp.einsum("bhts,bhsd->bhtd", probs, vd)
        out = out.transpose(0, 2, 1, 3).reshape(b, t, nh * hd)
        return self.wo(out), cache


# ---------------------------------------------------------------------------
# MoE block (SwiGLU experts on the grouped INT4 kernel)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=1)
def _random_experts(key, shape) -> MoEINT4:
    """Random stacked experts, quantized in one program so that the f32
    stack (1.9 GB at Mixtral-8x7B widths) is a transient XLA frees."""
    w = jax.random.normal(key, shape, jnp.float32) * (shape[-1] ** -0.5)
    return MoEINT4.from_dense(w)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MoEBlock:
    router: QuantizedLinear          # hidden -> num_experts (gate)
    w_gate: MoEINT4                  # [E, ffn, hidden]
    w_up: MoEINT4                    # [E, ffn, hidden]
    w_down: MoEINT4                  # [E, hidden, ffn]
    num_experts: int = dataclasses.field(metadata=dict(static=True))
    top_k: int = dataclasses.field(metadata=dict(static=True))
    # 16 rows: the smallest m-block a tensor-core dot takes, so decode
    # pads each expert's few tokens as little as possible.
    tile_m: int = dataclasses.field(metadata=dict(static=True), default=16)
    prefill_threshold: int = dataclasses.field(
        metadata=dict(static=True), default=512
    )
    # Prefill-regime implementation:
    #   "grouped" — DROPLESS tile-packed plan through the grouped INT4
    #     matmul with a larger tile_m. Default: Mixtral semantics are
    #     dropless, and the capacity path zeroes overflow tokens.
    #   "einsum" — capacity-layout dequant-once einsums (Switch-style drops
    #     beyond capacity_factor x mean load); kept for benchmarks and as the
    #     XLA-streaming comparison point.
    prefill_impl: str = dataclasses.field(
        metadata=dict(static=True), default="grouped"
    )
    # Per-expert padding waste stays < tile_m rows per expert, negligible
    # beyond the prefill threshold.
    prefill_tile_m: int = dataclasses.field(metadata=dict(static=True), default=128)
    capacity_factor: float = dataclasses.field(
        metadata=dict(static=True), default=2.0
    )
    # "kernel" (default): dropless tile-packed dispatch through the grouped
    # INT4 matmul. "xla_turbo"/"u4_turbo": capacity layout + int8 batched
    # XLA dots at prefill (ops/int8_xla.py); Switch-style capacity drop
    # semantics at capacity_factor x mean load.
    moe_impl: str = dataclasses.field(metadata=dict(static=True), default="kernel")

    @classmethod
    def init(cls, key, num_experts, hidden, ffn, top_k, tile_m=16):
        k0, k1, k2, k3 = jax.random.split(key, 4)
        return cls(
            router=QuantizedLinear.init(k0, hidden, num_experts),
            w_gate=_random_experts(k1, (num_experts, ffn, hidden)),
            w_up=_random_experts(k2, (num_experts, ffn, hidden)),
            w_down=_random_experts(k3, (num_experts, hidden, ffn)),
            num_experts=num_experts, top_k=top_k, tile_m=tile_m,
        )

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:  # [B, T, H]
        b, t, h = x.shape
        xf = x.reshape(b * t, h)
        routing = topk_route(self.router(xf), self.top_k, self.num_experts)
        transient_ok = self.w_gate.weight.granularity in (
            "per_row", "per_tensor"
        )
        if self.moe_impl == "u4_turbo" and not transient_ok:
            # per_group scales can't fold past an integer dot (the transient
            # path rejects them); the dropless grouped pg kernel handles
            # every regime instead.
            pass
        elif self.moe_impl in ("xla_turbo", "u4_turbo"):
            # Decode stays DROPLESS: the capacity layout drops tokens routed
            # beyond capacity_factor x mean load (Switch semantics), which is
            # acceptable as a prefill throughput trade but a silent semantic
            # change at decode, so the turbo modes only change prefill.
            # u4_turbo keeps PACKED weight residency and unpacks a
            # per-call transient i8 tensor; xla_turbo streams a permanent
            # i8-resident copy (2x packed memory, no unpack cost).
            if b * t <= self.prefill_threshold:
                return self._grouped_forward(
                    xf, routing, self.tile_m
                ).reshape(b, t, h)
            return self._capacity_i8_forward(
                xf, routing, transient=self.moe_impl == "u4_turbo"
            ).reshape(b, t, h)
        if b * t > self.prefill_threshold:
            if self.prefill_impl == "einsum":
                return self._prefill_forward(xf, routing).reshape(b, t, h)
            # dropless grouped-kernel prefill with a larger m-tile
            return self._grouped_forward(
                xf, routing, self.prefill_tile_m
            ).reshape(b, t, h)
        return self._grouped_forward(xf, routing, self.tile_m).reshape(b, t, h)

    def _grouped_forward(self, xf, routing, tile_m) -> jnp.ndarray:
        """Dropless path: tile-packed dispatch -> grouped kernel -> combine."""
        plan = make_dispatch_plan(routing, self.num_experts, tile_m=tile_m)
        xs = dispatch(xf, routing, plan)               # [T_pad, H]
        g = self.w_gate(xs, plan.tile_group_ids, tile_m=tile_m)
        u = self.w_up(xs, plan.tile_group_ids, tile_m=tile_m)
        hsw = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)).astype(
            xs.dtype
        )
        d = self.w_down(hsw, plan.tile_group_ids, tile_m=tile_m)
        return combine(d, routing, plan)

    def _capacity_i8_forward(
        self, xf: jnp.ndarray, routing, *, transient: bool = False
    ) -> jnp.ndarray:
        """Capacity layout + integer batched XLA dots.

        transient=False (xla_turbo): streams the permanent i8-resident
        copies attached by `as_xla_turbo` (2x packed memory).
        transient=True (u4_turbo): unpacks the PACKED weights in-graph to
        per-call transient i8 tensors (`ops.int8_xla.int4_grouped_transient`)
        — true 4-bit residency, same integer dot.
        """
        from ..layers.moe import make_capacity_plan
        from ..ops.int8_xla import int4_grouped_transient, int8_grouped_capacity

        tk = xf.shape[0] * self.top_k
        cf = self.capacity_factor
        cap = int(-(-cf * tk // self.num_experts // self.tile_m)) * self.tile_m
        plan = make_capacity_plan(
            routing, self.num_experts, capacity=cap, tile_m=self.tile_m
        )
        xs = dispatch(xf, routing, plan)  # [E*C, H]
        e, c = self.num_experts, cap
        xe = xs.reshape(e, c, -1)
        if transient:
            mm = lambda a, lin: int4_grouped_transient(a, lin.weight)  # noqa: E731
        else:
            mm = lambda a, lin: int8_grouped_capacity(a, lin.w8)  # noqa: E731
        g = mm(xe, self.w_gate)
        u = mm(xe, self.w_up)
        hsw = (
            jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
        ).astype(xs.dtype)
        d = mm(hsw, self.w_down)
        return combine(d.reshape(e * c, -1), routing, plan)

    def _prefill_forward(self, xf: jnp.ndarray, routing) -> jnp.ndarray:
        """Capacity-einsum prefill (prefill_impl="einsum"): capacity layout +
        dequant-once dense einsums.

        Dequantizing each projection once and running XLA batched einsums over
        the static [E, C, H] capacity layout streams weights at XLA's rate.
        Capacity = capacity_factor x mean load: overflow tokens DROP (Switch
        semantics) — use `expert_load_stats(routing, capacity)` to observe
        drop counts; the default prefill path ("grouped") is dropless.
        """
        from ..layers.moe import make_capacity_plan
        from ..quant.core import dequantize

        tk = xf.shape[0] * self.top_k
        cf = self.capacity_factor
        cap = int(-(-cf * tk // self.num_experts // self.tile_m)) * self.tile_m
        plan = make_capacity_plan(
            routing, self.num_experts, capacity=cap, tile_m=self.tile_m
        )
        xs = dispatch(xf, routing, plan)  # [E*C, H]
        e, c = self.num_experts, cap
        xe = xs.reshape(e, c, -1)
        dt = xs.dtype
        wg = dequantize(self.w_gate.weight, dtype=dt)
        wu = dequantize(self.w_up.weight, dtype=dt)
        g = jnp.einsum("ech,enh->ecn", xe, wg)
        u = jnp.einsum("ech,enh->ecn", xe, wu)
        hsw = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)).astype(dt)
        wd = dequantize(self.w_down.weight, dtype=dt)
        d = jnp.einsum("ecn,ehn->ech", hsw, wd)
        return combine(d.reshape(e * c, -1), routing, plan)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransformerBlock:
    attn_norm: jnp.ndarray
    attn: Attention
    moe_norm: jnp.ndarray
    moe: MoEBlock
    rms_eps: float = dataclasses.field(metadata=dict(static=True))

    def __call__(self, x, cache, positions):
        h, cache = self.attn(rms_norm(x, self.attn_norm, self.rms_eps), cache, positions)
        x = x + h
        x = x + self.moe(rms_norm(x, self.moe_norm, self.rms_eps))
        return x, cache


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedTransformer:
    """INT4 weight-only Mixtral-style decoder."""

    embed: jnp.ndarray              # [V, H] bf16 (unquantized, tied none)
    blocks: Tuple[TransformerBlock, ...]
    final_norm: jnp.ndarray
    lm_head: QuantizedLinear
    rms_eps: float = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def init(cls, key, cfg: ModelConfig, dtype=jnp.bfloat16):
        hidden = cfg.num_heads * cfg.head_dim
        keys = jax.random.split(key, cfg.num_layers + 2)
        blocks = []
        for i in range(cfg.num_layers):
            ka, km = jax.random.split(keys[i])
            blocks.append(
                TransformerBlock(
                    attn_norm=jnp.ones((hidden,), dtype),
                    attn=Attention.init(ka, cfg, hidden),
                    moe_norm=jnp.ones((hidden,), dtype),
                    moe=MoEBlock.init(
                        km, cfg.moe.num_experts, hidden, cfg.moe.ffn_dim,
                        cfg.moe.top_k,
                    ),
                    rms_eps=cfg.rms_eps,
                )
            )
        embed = (
            jax.random.normal(keys[-2], (cfg.vocab_size, hidden), jnp.float32) * 0.02
        ).astype(dtype)
        return cls(
            embed=embed,
            blocks=tuple(blocks),
            final_norm=jnp.ones((hidden,), dtype),
            lm_head=QuantizedLinear.init(keys[-1], hidden, cfg.vocab_size),
            rms_eps=cfg.rms_eps,
        )

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int):
        return tuple(
            QuantizedKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
            for _ in range(len(self.blocks))
        )

    def init_paged_cache(
        self, cfg: ModelConfig, batch: int, *,
        num_pages: int, page_size: int, max_pages_per_slot: int,
    ):
        """Paged KV caches (one page pool per layer; `layers.paged_kv`).

        Page ids are pool-local, so the serving engine can run one
        allocator and apply the same assignment to every layer."""
        from ..layers.paged_kv import PagedKVCache

        return tuple(
            PagedKVCache.init(
                batch, cfg.num_kv_heads, cfg.head_dim,
                num_pages=num_pages, page_size=page_size,
                max_pages_per_slot=max_pages_per_slot,
            )
            for _ in range(len(self.blocks))
        )

    def __call__(
        self,
        tokens: jnp.ndarray,        # [B, T] i32
        caches,                     # tuple of per-layer QuantizedKVCache
        positions: jnp.ndarray,     # [T] or [B, T] i32
    ):
        if positions.ndim == 1:
            positions = jnp.broadcast_to(positions[None, :], tokens.shape)
        x = self.embed[tokens]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, positions)
            new_caches.append(cache)
        x = rms_norm(x, self.final_norm, self.rms_eps)
        logits = self.lm_head(x)
        return logits, tuple(new_caches)

    @property
    def nbytes(self) -> int:
        return sum(
            a.size * a.dtype.itemsize for a in jax.tree_util.tree_leaves(self)
        )


def as_xla_turbo(model: "QuantizedTransformer") -> "QuantizedTransformer":
    """Switch a model to the int8-resident XLA execution mode.

    Every QuantizedLinear gains an i8 weight copy + the int8_xla activation
    path, and every MoE block switches to the capacity-layout batched int8
    dots (`moe_impl="xla_turbo"`). Use on platforms where XLA matmuls stream
    weights faster than Pallas DMA pipelines (see ops/int8_xla.py); weight
    memory is 2x the packed-u4 form, quality identical to w4a8.
    """
    from ..ops.int8_xla import to_int8_resident

    def conv_moe(m: MoEINT4) -> MoEINT4:
        return dataclasses.replace(m, w8=to_int8_resident(m.weight))

    blocks = []
    for blk in model.blocks:
        attn = dataclasses.replace(
            blk.attn,
            wq=blk.attn.wq.as_xla_turbo(), wk=blk.attn.wk.as_xla_turbo(),
            wv=blk.attn.wv.as_xla_turbo(), wo=blk.attn.wo.as_xla_turbo(),
        )
        moe = dataclasses.replace(
            blk.moe,
            router=blk.moe.router.as_xla_turbo(),
            w_gate=conv_moe(blk.moe.w_gate),
            w_up=conv_moe(blk.moe.w_up),
            w_down=conv_moe(blk.moe.w_down),
            moe_impl="xla_turbo",
        )
        blocks.append(dataclasses.replace(blk, attn=attn, moe=moe))
    return dataclasses.replace(
        model, blocks=tuple(blocks), lm_head=model.lm_head.as_xla_turbo()
    )


def as_u4_turbo(model: "QuantizedTransformer") -> "QuantizedTransformer":
    """Switch a model to packed-residency regime-dispatched execution.

    No weight copies are made (unlike `as_xla_turbo`'s permanent 2x i8
    residents): every layer keeps only its packed-u4 weights. Decode-size
    calls run the fused INT4 kernels; prefill-size calls unpack a per-call
    TRANSIENT i8 tensor in-graph and run XLA's integer dots
    (`ops/int8_xla.py` transient mode). MoE prefill uses the capacity layout
    (Switch drop semantics at capacity_factor x mean load, same trade as
    xla_turbo prefill); decode stays dropless.
    """

    def conv_linear(l):
        if not isinstance(l, QuantizedLinear):
            return l
        return l.as_u4_turbo()

    blocks = []
    for blk in model.blocks:
        attn = dataclasses.replace(
            blk.attn,
            wq=conv_linear(blk.attn.wq), wk=conv_linear(blk.attn.wk),
            wv=conv_linear(blk.attn.wv), wo=conv_linear(blk.attn.wo),
        )
        moe = dataclasses.replace(
            blk.moe, router=conv_linear(blk.moe.router), moe_impl="u4_turbo",
        )
        blocks.append(dataclasses.replace(blk, attn=attn, moe=moe))
    return dataclasses.replace(
        model, blocks=tuple(blocks), lm_head=conv_linear(model.lm_head)
    )


def as_per_group(
    model: "QuantizedTransformer", group_size: int = 128
) -> "QuantizedTransformer":
    """Requantize every INT4 weight to per_group granularity.

    per-group is the production INT4 granularity (best quality in the
    trained-fixture ladder, `benchmark/results/quality_trained*.json`);
    with group_size % 128 == 0 the weights pack group-major
    (layout="planar_groups"). The fused kernels take one group per K step.

    Requantization goes through the already-quantized values (dequantize →
    re-quantize), so this is for execution-mode experiments on synthetic
    models and serving benchmarks; real conversions should quantize the
    original checkpoint directly (`models.convert`, granularity=...).
    """
    from ..quant.core import dequantize as _dq, quantize as _q

    def requant(w):
        if w.granularity == "per_group" or (w.in_dim // 2) % group_size:
            return None
        return _q(
            _dq(w, dtype=jnp.float32), granularity="per_group",
            group_size=group_size,
            layout="planar_groups" if group_size % 128 == 0 else "planar",
        )

    def conv_linear(l):
        if not isinstance(l, QuantizedLinear):
            return l
        qt = requant(l.weight)
        return l if qt is None else dataclasses.replace(l, weight=qt)

    def conv_moe(m: MoEINT4) -> MoEINT4:
        qt = requant(m.weight)
        return m if qt is None else dataclasses.replace(m, weight=qt)

    blocks = []
    for blk in model.blocks:
        attn = dataclasses.replace(
            blk.attn,
            wq=conv_linear(blk.attn.wq), wk=conv_linear(blk.attn.wk),
            wv=conv_linear(blk.attn.wv), wo=conv_linear(blk.attn.wo),
        )
        moe = dataclasses.replace(
            blk.moe,
            w_gate=conv_moe(blk.moe.w_gate),
            w_up=conv_moe(blk.moe.w_up),
            w_down=conv_moe(blk.moe.w_down),
        )
        blocks.append(dataclasses.replace(blk, attn=attn, moe=moe))
    return dataclasses.replace(
        model, blocks=tuple(blocks), lm_head=conv_linear(model.lm_head)
    )
