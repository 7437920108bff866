"""int8-resident XLA execution path (ops/int8_xla.py).

Same int4 weights, int8 activations, XLA's integer dot. Correctness gates:
exact integer-grid recovery and agreement with the dequant golden.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.layers.linear import QuantizedLinear
from fused4bit.ops.int8_xla import (
    Int8Resident,
    int8_grouped_capacity,
    int8_linear,
    to_int8_resident,
)
from fused4bit.quant import dequantize, quantize


def randw(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


class TestInt8Resident:
    def test_exact_integer_grid_recovery(self, rng):
        """q8 == (q - zp) exactly: integers in [-15, 15]."""
        w = randw(rng, 64, 128)
        qt = quantize(w, layout="planar")
        w8 = to_int8_resident(qt)
        q = np.asarray(w8.q8)
        assert q.min() >= -15 and q.max() <= 15
        # dequant equality: q8 * s == dequantize(qt)
        wd = np.asarray(dequantize(qt, jnp.float32))
        np.testing.assert_allclose(
            q * np.asarray(w8.scales)[:, None], wd, rtol=1e-6, atol=1e-6
        )

    def test_linear_module_mode(self, rng):
        w = randw(rng, 96, 128)
        x = randw(rng, 4, 128)
        lin = QuantizedLinear.from_dense(w)
        turbo = lin.as_xla_turbo()
        got = turbo(x)
        want = x @ np.asarray(dequantize(lin.weight, jnp.float32)).T
        rel = float(jnp.max(jnp.abs(got - want))) / float(jnp.max(jnp.abs(want)))
        assert rel < 0.03  # int8 activation quantization error budget

    def test_grouped_capacity(self, rng):
        e, c, k, n = 4, 8, 128, 96
        w = randw(rng, e, n, k)
        qt = quantize(w, layout="planar")
        xe = randw(rng, e, c, k)
        got = int8_grouped_capacity(xe, to_int8_resident(qt))
        wd = dequantize(qt, jnp.float32)
        want = jnp.einsum("eck,enk->ecn", xe, wd)
        rel = float(jnp.max(jnp.abs(got - want))) / float(jnp.max(jnp.abs(want)))
        assert rel < 0.03


class TestXlaTurboModel:
    @pytest.mark.slow
    def test_model_decode_matches_standard(self, rng):
        from fused4bit.models.config import flagship_model_config
        from fused4bit.models.transformer import (
            QuantizedTransformer, as_xla_turbo,
        )

        cfg = flagship_model_config("tiny")
        model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
        turbo = as_xla_turbo(model)
        toks = jnp.asarray([[5, 7, 9]], jnp.int32)
        pos = jnp.arange(3)
        c1 = model.init_cache(cfg, 1, 16)
        c2 = model.init_cache(cfg, 1, 16)
        l1, _ = model(toks, c1, pos)
        l2, _ = turbo(toks, c2, pos)
        a = np.asarray(l1[0, -1], np.float32)
        b = np.asarray(l2[0, -1], np.float32)
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.98, cos


class TestTransientUnpack:
    """u4-residency transient mode: packed weights unpacked in-graph to a
    per-call i8 tensor, same integer dot as the resident mode."""

    def test_linear_bitwise_matches_resident(self, rng):
        from fused4bit.ops.int8_xla import int4_linear_transient

        w = randw(rng, 96, 128)
        qt = quantize(w, layout="planar")
        x = randw(rng, 8, 128)
        got = int4_linear_transient(x, qt)
        want = int8_linear(x, to_int8_resident(qt))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_grouped_matches_golden(self, rng):
        from fused4bit.ops.int8_xla import int4_grouped_transient

        e, c, k, n = 4, 8, 128, 96
        w = randw(rng, e, n, k)
        for gran in ("per_row", "per_tensor"):
            qt = quantize(w, layout="planar", granularity=gran)
            xe = randw(rng, e, c, k)
            got = int4_grouped_transient(xe, qt)
            wd = dequantize(qt, jnp.float32)
            want = jnp.einsum("eck,enk->ecn", xe, wd)
            rel = float(jnp.max(jnp.abs(got - want))) / float(
                jnp.max(jnp.abs(want))
            )
            assert rel < 0.03, gran

    def test_per_group_rejected(self, rng):
        from fused4bit.ops.int8_xla import int4_linear_transient

        w = randw(rng, 8, 256)
        qt = quantize(w, layout="planar", granularity="per_group",
                      group_size=128)
        with pytest.raises(ValueError, match="per_row/per_tensor"):
            int4_linear_transient(randw(rng, 2, 256), qt)

    def test_linear_auto_regime_dispatch(self, rng):
        """as_u4_turbo linears: decode m uses the fused kernel, prefill m
        the transient path — both must agree with the dequant golden."""
        w = randw(rng, 96, 128)
        lin = QuantizedLinear.from_dense(w).as_u4_turbo()
        wd = np.asarray(dequantize(lin.weight, jnp.float32))
        for m in (4, QuantizedLinear._AUTO_PREFILL_M):
            x = randw(rng, m, 128)
            got = np.asarray(lin(x), np.float32)
            want = np.asarray(x, np.float32) @ wd.T
            rel = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
            assert rel < 0.03, m


class TestU4TurboModel:
    @pytest.mark.slow
    def test_model_prefill_matches_standard(self, rng):
        """Prefill-regime forward (T > prefill_threshold) through the
        capacity+transient path agrees with the dropless kernel model."""
        import dataclasses as dc

        from fused4bit.models.config import flagship_model_config
        from fused4bit.models.transformer import (
            QuantizedTransformer, as_u4_turbo,
        )

        cfg = flagship_model_config("tiny")
        model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
        turbo = as_u4_turbo(model)
        # no resident copies anywhere: packed residency is the mode's point
        assert all(
            lin.w8 is None
            for blk in turbo.blocks
            for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo)
        )
        # force the prefill branch at a tiny T by lowering the threshold
        blocks = tuple(
            dc.replace(b, moe=dc.replace(b.moe, prefill_threshold=2))
            for b in turbo.blocks
        )
        turbo = dc.replace(turbo, blocks=blocks)
        t = 8
        toks = jnp.asarray([list(range(5, 5 + t))], jnp.int32)
        pos = jnp.arange(t)
        l1, _ = model(toks, model.init_cache(cfg, 1, 16), pos)
        l2, _ = turbo(toks, turbo.init_cache(cfg, 1, 16), pos)
        a = np.asarray(l1[0, -1], np.float32)
        b = np.asarray(l2[0, -1], np.float32)
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.98, cos
