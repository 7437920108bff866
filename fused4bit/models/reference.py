"""Plain float32 reference forward of :class:`QuantizedTransformer`.

No KV cache and no kernels: each layer's INT4 weights are dequantized to
float32 inside that layer's program, and every product runs at HIGHEST
precision. K and V go through the INT4 cache's per-vector rounding (16
levels between each [D] vector's min and max), which is part of the model's
function. Only one layer's float32 weights exist at a time (about 5.6 GB at
Mixtral-8x7B widths), so the full model can be checked on one card. Every
expert is evaluated for every token and the router's top-k weights select
among them. Routing, RoPE and the KV rounding are written again here, so
that no code of the path under test but the weights' dequantization is
shared with it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..quant.core import dequantize
from .transformer import QuantizedTransformer, TransformerBlock

__all__ = ["reference_logits"]

_HI = jax.lax.Precision.HIGHEST


def _dense(lin) -> jnp.ndarray:
    """float32 [N, K] weight of a QuantizedLinear (padded rows dropped)."""
    return dequantize(lin.weight, dtype=jnp.float32)[: lin.out_dim]


def _rms(x, gamma, eps):
    var = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32)


def _kv_round(x):
    """The INT4 cache's rounding of each [D] vector, back in float32: 15
    steps from the vector's min to its max, the zero point an integer step
    (a constant vector gets max(|x|, 1) / 15 as its step)."""
    lo = jnp.min(x, axis=-1, keepdims=True)
    hi = jnp.max(x, axis=-1, keepdims=True)
    step = jnp.where(hi == lo, jnp.maximum(jnp.abs(hi), 1.0), hi - lo) / 15.0
    step = jnp.maximum(step, 1e-8)
    zp = jnp.clip(jnp.round(-lo / step), 0.0, 15.0)
    q = jnp.clip(jnp.round(x / step + zp), 0.0, 15.0)
    return (q - zp) * step


def _rope(x, theta):
    """Half-split rotary embedding of x [B, H, T, D] at positions 0..T-1."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (jnp.arange(d // 2, dtype=jnp.float32) * 2.0 / d)
    ang = jnp.arange(x.shape[2], dtype=jnp.float32)[:, None] * inv[None, :]
    c, s = jnp.cos(ang), jnp.sin(ang)
    a, b = x[..., : d // 2], x[..., d // 2:]
    return jnp.concatenate([a * c - b * s, b * c + a * s], axis=-1)


def _gates(router_logits, top_k):
    """[T, E] weights: softmax over the experts, the top_k kept and
    renormalised, the others zero."""
    probs = jax.nn.softmax(router_logits, axis=-1)
    w, idx = jax.lax.top_k(probs, top_k)
    w = w / jnp.sum(w, axis=-1, keepdims=True)
    return jnp.sum(jax.nn.one_hot(idx, probs.shape[-1]) * w[..., None], axis=1)


def _mm(x, w):
    return jnp.einsum("btk,nk->btn", x, w, precision=_HI)


@jax.jit
def _block(blk: TransformerBlock, x: jnp.ndarray) -> jnp.ndarray:
    """One decoder layer on float32 activations x [B, T, H]."""
    b, t, _ = x.shape
    at = blk.attn
    nh, nkv, hd = at.num_heads, at.num_kv_heads, at.head_dim
    pos = jnp.arange(t)
    h = _rms(x, blk.attn_norm, blk.rms_eps)
    q = _mm(h, _dense(at.wq)).reshape(b, t, nh, hd).transpose(0, 2, 1, 3)
    k = _mm(h, _dense(at.wk)).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
    v = _mm(h, _dense(at.wv)).reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
    q = _rope(q, at.rope_theta)
    k = _rope(k, at.rope_theta)
    k = jnp.repeat(_kv_round(k), nh // nkv, axis=1)
    v = jnp.repeat(_kv_round(v), nh // nkv, axis=1)
    s = jnp.einsum("bhtd,bhsd->bhts", q, k, precision=_HI) * hd ** -0.5
    s = jnp.where(pos[None, :] <= pos[:, None], s, -jnp.inf)
    o = jnp.einsum("bhts,bhsd->bhtd", jax.nn.softmax(s, axis=-1), v, precision=_HI)
    x = x + _mm(o.transpose(0, 2, 1, 3).reshape(b, t, nh * hd), _dense(at.wo))

    moe = blk.moe
    h = _rms(x, blk.moe_norm, blk.rms_eps).reshape(b * t, -1)
    gate = _gates(
        jnp.einsum("tk,nk->tn", h, _dense(moe.router), precision=_HI), moe.top_k
    )
    wg = dequantize(moe.w_gate.weight, dtype=jnp.float32)
    wu = dequantize(moe.w_up.weight, dtype=jnp.float32)
    wd = dequantize(moe.w_down.weight, dtype=jnp.float32)
    g = jnp.einsum("tk,enk->etn", h, wg, precision=_HI)
    u = jnp.einsum("tk,enk->etn", h, wu, precision=_HI)
    y = jnp.einsum("etn,ehn->eth", jax.nn.silu(g) * u, wd, precision=_HI)
    return x + jnp.einsum("te,eth->th", gate, y, precision=_HI).reshape(b, t, -1)


@jax.jit
def _head(model: QuantizedTransformer, x: jnp.ndarray) -> jnp.ndarray:
    h = _rms(x, model.final_norm, model.rms_eps)
    return jnp.einsum("btk,nk->btn", h, _dense(model.lm_head), precision=_HI)


def reference_logits(model: QuantizedTransformer, tokens: jnp.ndarray) -> jnp.ndarray:
    """float32 logits [B, T, V] of a causal forward over tokens [B, T] from
    position 0. Right-padding a prompt leaves its earlier logits unchanged,
    so prompts of several lengths can share one padded batch (and one
    compilation of the layer program)."""
    x = model.embed[tokens].astype(jnp.float32)
    for blk in model.blocks:
        x = _block(blk, x)
    return _head(model, x)
