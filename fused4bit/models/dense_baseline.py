"""Dense bf16 twin of the INT4 model — the model-level baseline.

The reference benchmarks its kernels against dense FP16 compute
(`benchmark/run_benchmark.py`, naive/bmm MoE baselines); at
the model level the analogous baseline is this: the same architecture with
bf16 dense weights, a bf16 KV cache, and plain XLA matmuls. Built *from* a
`QuantizedTransformer` by dequantizing its weights, so the two models
represent the identical function up to quantization error — which makes both
an honest speed comparison and a model-level quality measurement possible
(see tests/test_model.py and benchmark/run_model_benchmark.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..layers.moe import topk_route
from ..quant.core import dequantize
from .transformer import QuantizedTransformer, rms_norm, rotary_embedding

__all__ = ["DenseTransformer", "dense_from_quantized", "DenseKVCache"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseKVCache:
    k: jnp.ndarray        # [B, H, S, D] bf16
    v: jnp.ndarray
    lengths: jnp.ndarray  # [B] i32

    @classmethod
    def init(cls, batch, num_kv_heads, max_seq, head_dim, dtype=jnp.bfloat16):
        z = jnp.zeros((batch, num_kv_heads, max_seq, head_dim), dtype)
        return cls(z, z, jnp.zeros((batch,), jnp.int32))

    @property
    def max_seq(self):
        return self.k.shape[2]

    @property
    def nbytes(self):
        return self.k.size * self.k.dtype.itemsize * 2

    def append(self, k, v, start=None):
        start = self.lengths if start is None else start
        upd = jax.vmap(
            lambda b, v_, s: jax.lax.dynamic_update_slice(b, v_, (0, s, 0))
        )
        return DenseKVCache(
            k=upd(self.k, k.astype(self.k.dtype), start),
            v=upd(self.v, v.astype(self.v.dtype), start),
            lengths=start + k.shape[2],
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseBlock:
    attn_norm: jnp.ndarray
    wq: jnp.ndarray
    wk: jnp.ndarray
    wv: jnp.ndarray
    wo: jnp.ndarray
    moe_norm: jnp.ndarray
    router: jnp.ndarray      # [E, H]
    w_gate: jnp.ndarray      # [E, ffn, H]
    w_up: jnp.ndarray
    w_down: jnp.ndarray      # [E, H, ffn]
    num_heads: int = dataclasses.field(metadata=dict(static=True))
    num_kv_heads: int = dataclasses.field(metadata=dict(static=True))
    head_dim: int = dataclasses.field(metadata=dict(static=True))
    rope_theta: float = dataclasses.field(metadata=dict(static=True))
    top_k: int = dataclasses.field(metadata=dict(static=True))
    rms_eps: float = dataclasses.field(metadata=dict(static=True))
    # MoE execution strategy for the baseline:
    #   "gather" — per-token expert weight gather (the reference's naive-FP16
    #     comparison philosophy: materializes [T*k, ffn, H] weight copies).
    #   "dense_all" — STRONG baseline: run every token through every expert
    #     with one batched einsum per projection (each expert's weights
    #     stream from device memory exactly once — the memory-bound optimum for
    #     decode-size T), then weight by the router's top-k scores. Dropless
    #     and gather-free; extra FLOPs (E/top_k x) are irrelevant in the
    #     weight-streaming-bound decode regime this baseline serves.
    moe_impl: str = dataclasses.field(metadata=dict(static=True), default="gather")

    def __call__(self, x, cache: DenseKVCache, positions, capture=None):
        """capture: optional list collecting ("attn_in"/"moe_in", h) norm
        outputs — the calibration tap for activation-aware quantization
        (quant/equalize.py). Run eagerly when capturing."""
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        h = rms_norm(x, self.attn_norm, self.rms_eps)
        if capture is not None:
            capture.append(("attn_in", h))
        q = (h @ self.wq.T).reshape(b, t, nh, hd).transpose(0, 2, 1, 3)
        k = (h @ self.wk.T).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
        v = (h @ self.wv.T).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
        q = rotary_embedding(q, positions, self.rope_theta)
        k = rotary_embedding(k, positions, self.rope_theta)
        cache = cache.append(k, v, start=positions[:, 0])
        kd, vd = cache.k.astype(q.dtype), cache.v.astype(q.dtype)
        rep = nh // nkv
        kd = jnp.repeat(kd, rep, axis=1)
        vd = jnp.repeat(vd, rep, axis=1)
        scores = jnp.einsum("bhtd,bhsd->bhts", q, kd) / jnp.sqrt(float(hd))
        span = jnp.arange(cache.max_seq)[None, None, :]
        causal = span <= positions[:, :, None]
        scores = jnp.where(causal[:, None], scores.astype(jnp.float32), -1e30)
        probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
        attn = jnp.einsum("bhts,bhsd->bhtd", probs, vd)
        attn = attn.transpose(0, 2, 1, 3).reshape(b, t, nh * hd)
        x = x + attn @ self.wo.T

        h = rms_norm(x, self.moe_norm, self.rms_eps)
        if capture is not None:
            capture.append(("moe_in", h))
        bt = b * t
        hf = h.reshape(bt, -1)
        routing = topk_route(hf @ self.router.T, self.top_k, self.router.shape[0])
        if self.moe_impl == "dense_all":
            # Strong baseline: every token x every expert, one streamed
            # einsum per projection, router-weighted combine.
            g = jnp.einsum("th,efh->tef", hf, self.w_gate)
            u = jnp.einsum("th,efh->tef", hf, self.w_up)
            act = (
                jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
            ).astype(hf.dtype)
            d = jnp.einsum("tef,ehf->teh", act, self.w_down)  # [T, E, H]
            e = self.router.shape[0]
            wmat = jnp.zeros((bt, e), jnp.float32).at[
                jnp.arange(bt)[:, None], routing.expert_indices
            ].add(routing.expert_weights)
            y = jnp.einsum("teh,te->th", d.astype(jnp.float32), wmat).astype(hf.dtype)
        else:
            # Per-token expert gather (the reference's naive-FP16 philosophy)
            wg = self.w_gate[routing.expert_indices]   # [bt, k, ffn, H]
            wu = self.w_up[routing.expert_indices]
            wd = self.w_down[routing.expert_indices]   # [bt, k, H, ffn]
            g = jnp.einsum("bh,bkfh->bkf", hf, wg)
            u = jnp.einsum("bh,bkfh->bkf", hf, wu)
            act = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)).astype(hf.dtype)
            d = jnp.einsum("bkf,bkhf->bkh", act, wd)
            y = jnp.sum(d * routing.expert_weights[..., None].astype(d.dtype), axis=1)
        return x + y.reshape(b, t, -1), cache


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseTransformer:
    embed: jnp.ndarray
    blocks: Tuple[DenseBlock, ...]
    final_norm: jnp.ndarray
    lm_head: jnp.ndarray
    rms_eps: float = dataclasses.field(metadata=dict(static=True))

    def init_cache(self, cfg, batch, max_seq, dtype=jnp.bfloat16):
        return tuple(
            DenseKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim, dtype)
            for _ in range(len(self.blocks))
        )

    def __call__(self, tokens, caches, positions, capture=None):
        if positions.ndim == 1:
            positions = jnp.broadcast_to(positions[None, :], tokens.shape)
        x = self.embed[tokens]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, positions, capture=capture)
            new_caches.append(cache)
        x = rms_norm(x, self.final_norm, self.rms_eps)
        if capture is not None:
            capture.append(("final_in", x))
        return x @ self.lm_head.T, tuple(new_caches)

    @property
    def nbytes(self):
        return sum(a.size * a.dtype.itemsize for a in jax.tree_util.tree_leaves(self))


def dense_from_quantized(
    model: QuantizedTransformer, dtype=jnp.bfloat16, moe_impl: str = "gather"
):
    """Dequantize an INT4 model into its dense bf16 twin.

    moe_impl: "gather" (naive per-token weight gather) or "dense_all"
    (strong streamed-einsum baseline) — see DenseBlock.moe_impl.
    """

    def dq(ql):
        return dequantize(ql.weight, dtype=dtype)

    blocks = []
    for blk in model.blocks:
        blocks.append(
            DenseBlock(
                attn_norm=blk.attn_norm,
                wq=dq(blk.attn.wq), wk=dq(blk.attn.wk),
                wv=dq(blk.attn.wv), wo=dq(blk.attn.wo),
                moe_norm=blk.moe_norm,
                router=dq(blk.moe.router),
                w_gate=dequantize(blk.moe.w_gate.weight, dtype=dtype),
                w_up=dequantize(blk.moe.w_up.weight, dtype=dtype),
                w_down=dequantize(blk.moe.w_down.weight, dtype=dtype),
                num_heads=blk.attn.num_heads,
                num_kv_heads=blk.attn.num_kv_heads,
                head_dim=blk.attn.head_dim,
                rope_theta=blk.attn.rope_theta,
                top_k=blk.moe.top_k,
                rms_eps=blk.rms_eps,
                moe_impl=moe_impl,
            )
        )
    return DenseTransformer(
        embed=model.embed.astype(dtype),
        blocks=tuple(blocks),
        final_norm=model.final_norm,
        lm_head=dequantize(model.lm_head.weight, dtype=dtype),
        rms_eps=model.rms_eps,
    )
