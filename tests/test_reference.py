"""The plain float32 reference forward (`fused4bit.models.reference`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.models.config import flagship_model_config
from fused4bit.models.reference import reference_logits
from fused4bit.models.transformer import QuantizedTransformer


@pytest.fixture(scope="module")
def f32_model():
    cfg = dataclasses.replace(flagship_model_config("tiny"), vocab_size=256)
    return cfg, QuantizedTransformer.init(jax.random.PRNGKey(0), cfg,
                                          dtype=jnp.float32)


def _tokens(cfg, b, t, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)),
        jnp.int32)


def test_reference_logits_match_f32_model(f32_model):
    """No cache, no kernels, per-layer dequantization: the same function as
    the cached forward of a float32 model (whose K/V round through the INT4
    cache, as the reference's do)."""
    cfg, m = f32_model
    toks = _tokens(cfg, 2, 16)
    with jax.default_matmul_precision("highest"):
        got, _ = m(toks, m.init_cache(cfg, 2, 16), jnp.arange(16))
        want = reference_logits(m, toks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_right_padding_leaves_logits_unchanged(f32_model):
    cfg, m = f32_model
    toks = _tokens(cfg, 1, 6, seed=1)
    a = reference_logits(m, toks)
    b = reference_logits(m, jnp.pad(toks, ((0, 0), (0, 4))))[:, :6]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_reference_sees_padded_linear_rows(f32_model):
    """Rows padded for the kernel (`padded_for_kernel`) are dropped."""
    from fused4bit.quant.core import pad_rows

    cfg, m = f32_model
    head = dataclasses.replace(m.lm_head, weight=pad_rows(m.lm_head.weight, 96),
                               out_features=cfg.vocab_size)
    assert head.weight.out_dim != cfg.vocab_size
    padded = dataclasses.replace(m, lm_head=head)
    toks = _tokens(cfg, 1, 5, seed=2)
    got = reference_logits(padded, toks)
    assert got.shape == (1, 5, cfg.vocab_size)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(reference_logits(m, toks)), atol=1e-5)


def test_reference_rope_matches_model(rng):
    """The reference's own RoPE and the model's agree."""
    from fused4bit.models.reference import _rope
    from fused4bit.models.transformer import rotary_embedding

    x = jnp.asarray(rng.standard_normal((2, 3, 9, 16)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(_rope(x, 10000.0)),
        np.asarray(rotary_embedding(x, jnp.arange(9), 10000.0)),
        atol=1e-5,
    )


def test_reference_kv_rounding_matches_cache(rng):
    """The reference's own per-vector rounding and the INT4 cache's
    quantize-dequantize agree, constant vectors included."""
    from fused4bit.layers.kv_cache import dequantize_kv, quantize_kv
    from fused4bit.models.reference import _kv_round

    x = jnp.asarray(rng.standard_normal((4, 5, 32)), jnp.float32)
    x = x.at[0, 0].set(0.3).at[0, 1].set(-2.0).at[0, 2].set(0.0)
    np.testing.assert_allclose(
        np.asarray(_kv_round(x)), np.asarray(dequantize_kv(*quantize_kv(x))),
        atol=1e-6,
    )


def test_reference_gates_match_router(rng):
    """The reference's own top-k gate matrix and the router's top-k agree."""
    from fused4bit.layers.moe import topk_route
    from fused4bit.models.reference import _gates

    logits = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    r = topk_route(logits, 2, 8)
    want = np.zeros((16, 8), np.float32)
    for t in range(16):
        for i, w in zip(np.asarray(r.expert_indices[t]),
                        np.asarray(r.expert_weights[t])):
            want[t, i] += w
    np.testing.assert_allclose(np.asarray(_gates(logits, 2)), want, atol=1e-6)
