"""Activation-aware (AWQ-style) equalization: exactness + error reduction.

Ladder: (1) equalization is an EXACT reparameterization in full precision
(the dense model computes the same function before/after); (2) on a
distribution with salient activation channels it strictly reduces INT4
reconstruction error; (3) the convert pipeline accepts calibration tokens
end-to-end and the resulting model still tracks the unequalized one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.models.config import flagship_model_config
from fused4bit.quant.core import dequantize, quantize
from fused4bit.quant.equalize import (
    _dense_from_params,
    awq_equalize_params,
    awq_site_scale,
)

pytestmark = pytest.mark.slow


def _tiny_params(cfg, seed=0, outlier=None):
    """Random flat checkpoint dict for the tiny config; `outlier`: scale a
    few activation-salient input channels of every site's weights down and
    (via embed) activations up — the regime AWQ exists for."""
    rng = np.random.default_rng(seed)
    h = cfg.num_heads * cfg.head_dim
    ffn = cfg.moe.ffn_dim
    p = {}

    def w(shape, scale=None):
        k = shape[-1]
        return (rng.standard_normal(shape) * (scale or k ** -0.5)).astype(
            np.float32
        )

    p["embed.weight"] = w((cfg.vocab_size, h), 1.0)
    if outlier:
        # a few embed channels run hot -> salient activation channels
        p["embed.weight"][:, :outlier] *= 12.0
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        p[f"{pre}.attn_norm.weight"] = np.ones(h, np.float32)
        p[f"{pre}.attn.q_proj.weight"] = w((h, h))
        p[f"{pre}.attn.k_proj.weight"] = w(
            (cfg.num_kv_heads * cfg.head_dim, h))
        p[f"{pre}.attn.v_proj.weight"] = w(
            (cfg.num_kv_heads * cfg.head_dim, h))
        p[f"{pre}.attn.o_proj.weight"] = w((h, h))
        p[f"{pre}.moe_norm.weight"] = np.ones(h, np.float32)
        p[f"{pre}.moe.router.weight"] = w((cfg.moe.num_experts, h))
        for i in range(cfg.moe.num_experts):
            p[f"{pre}.moe.experts.{i}.w1.weight"] = w((ffn, h))
            p[f"{pre}.moe.experts.{i}.w3.weight"] = w((ffn, h))
            p[f"{pre}.moe.experts.{i}.w2.weight"] = w((h, ffn))
    p["final_norm.weight"] = np.ones(h, np.float32)
    p["lm_head.weight"] = w((cfg.vocab_size, h))
    return p


@pytest.fixture(scope="module")
def cfg():
    return flagship_model_config("tiny")


class TestEqualize:
    def test_equalization_is_exact_in_full_precision(self, cfg):
        """Scaled weights + divided norms = the same dense function."""
        params = _tiny_params(cfg)
        toks = np.arange(24, dtype=np.int32).reshape(2, 12) % cfg.vocab_size
        eq = awq_equalize_params(params, cfg, toks, alpha=0.5)
        d0 = _dense_from_params(params, cfg)
        d1 = _dense_from_params(eq, cfg)
        pos = jnp.broadcast_to(jnp.arange(12)[None], (2, 12)).astype(jnp.int32)
        l0, _ = d0(jnp.asarray(toks), d0.init_cache(cfg, 2, 12, jnp.float32), pos)
        l1, _ = d1(jnp.asarray(toks), d1.init_cache(cfg, 2, 12, jnp.float32), pos)
        rel = float(jnp.linalg.norm(l1 - l0) / jnp.linalg.norm(l0))
        assert rel < 5e-5, rel  # f32 round-trip of the fold only

    def test_site_scale_reduces_int4_error_on_salient_channels(self, cfg):
        """The defining property: with hot activation channels, quantizing
        W*s (and dividing the product back) reconstructs x@W^T strictly
        better than quantizing W directly."""
        rng = np.random.default_rng(1)
        k, n, t = 256, 384, 512
        x = rng.standard_normal((t, k)).astype(np.float32)
        x[:, :8] *= 20.0                      # salient channels
        w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
        xj, wj = jnp.asarray(x), jnp.asarray(w)
        ref = xj @ wj.T

        def err(s):
            qt = quantize((wj * s[None, :]).astype(jnp.float32),
                          granularity="per_row", layout="planar")
            wd = dequantize(qt, dtype=jnp.float32) / s[None, :]
            d = xj @ wd.T - ref
            return float(jnp.sum(d * d))

        e_plain = err(jnp.ones((k,), jnp.float32))
        s = awq_site_scale(xj, [wj])
        e_awq = err(s)
        assert e_awq < 0.8 * e_plain, (e_awq, e_plain)

    def test_convert_with_awq_tracks_baseline(self, cfg):
        """End-to-end: convert_checkpoint(awq_tokens=...) produces a model
        whose logits track the dense reference at least as well as the
        plain conversion on an outlier-heavy checkpoint."""
        from fused4bit.models.convert import convert_checkpoint

        params = _tiny_params(cfg, seed=2, outlier=6)
        toks = (np.arange(32, dtype=np.int32) * 7).reshape(2, 16) % cfg.vocab_size
        dense = _dense_from_params(params, cfg)
        pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16)).astype(jnp.int32)
        ref, _ = dense(jnp.asarray(toks),
                       dense.init_cache(cfg, 2, 16, jnp.float32), pos)

        def logits(model):
            caches = model.init_cache(cfg, 2, 16)
            out, _ = model(jnp.asarray(toks), caches, pos)
            return out.astype(jnp.float32)

        plain = convert_checkpoint(dict(params), cfg)
        awq = convert_checkpoint(dict(params), cfg, awq_tokens=toks)
        r = jnp.asarray(ref, jnp.float32)

        def cos(a):
            a = a.reshape(-1)
            b = r.reshape(-1)
            return float(a @ b / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))

        c_plain, c_awq = cos(logits(plain)), cos(logits(awq))
        assert c_awq >= c_plain - 1e-3, (c_plain, c_awq)
        assert c_awq > 0.95
