"""Quantization core tests — the reference's correctness ladder, level 1-2.

Mirrors `tests/test_correctness.py` of the reference:
  * round-trip quantize→dequantize within atol 0.5 (ref :49-75)
  * packing shape invariants (ref :77-83)
  * nibble range (ref :85-91)
  * constant-row edge case / NaN guard (ref :93-103)
  * reference-linear wrapper vs manual dequant+matmul at 1e-5 (ref :109-128)
  * quality vs FP32: mean abs err < 3.0, cosine sim > 0.95 (ref :140-168)
Plus new coverage the reference lacked: layout equivalence (interleaved vs
block_planar), per_tensor and per_group granularities, stacked (expert) dims.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.quant import (
    QuantizedTensor,
    choose_block_k,
    dequantize,
    dequantize_weights,
    interleaved_to_block_planar,
    pack_block_planar,
    pack_interleaved,
    quantize,
    quantize_weights,
    unpack_block_planar,
    unpack_interleaved,
    reference_linear_qt,
    reference_quantized_linear,
)


def randw(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


class TestRoundTrip:
    @pytest.mark.parametrize("shape", [(16, 32), (256, 512), (1024, 2048)])
    def test_roundtrip_per_row(self, rng, shape):
        w = randw(rng, *shape)
        qt = quantize(w, granularity="per_row")
        w2 = dequantize(qt)
        # Max error per element is scale/2 = (max-min)/30; for randn rows the
        # range is < 15 in practice, so 0.5 abs tolerance (reference :40-47).
        assert jnp.max(jnp.abs(w2 - w)) < 0.5

    @pytest.mark.parametrize("granularity,kw", [
        ("per_tensor", {}),
        ("per_group", dict(group_size=64)),
    ])
    def test_roundtrip_granularities(self, rng, granularity, kw):
        w = randw(rng, 128, 256)
        qt = quantize(w, granularity=granularity, **kw)
        w2 = dequantize(qt)
        tol = 0.8 if granularity == "per_tensor" else 0.5
        assert jnp.max(jnp.abs(w2 - w)) < tol
        # Finer granularity must reconstruct at least as well on average.
        if granularity == "per_group":
            per_row = dequantize(quantize(w, granularity="per_row"))
            assert jnp.mean(jnp.abs(w2 - w)) <= jnp.mean(jnp.abs(per_row - w)) + 1e-6

    def test_roundtrip_stacked_experts(self, rng):
        w = randw(rng, 4, 64, 128)  # [E, N, K]
        for g in ("per_row", "per_tensor"):
            qt = quantize(w, granularity=g)
            assert dequantize(qt).shape == w.shape
            assert jnp.max(jnp.abs(dequantize(qt) - w)) < 1.0

    def test_packing_shapes(self, rng):
        w = randw(rng, 64, 128)
        packed, scales, zp = quantize_weights(w)
        assert packed.shape == (64, 64)
        assert packed.dtype == jnp.uint8
        assert scales.shape == (64,)
        assert zp.shape == (64,)

    def test_nibble_range(self, rng):
        w = randw(rng, 32, 64) * 100
        packed, _, _ = quantize_weights(w)
        lo = packed & 0x0F
        hi = packed >> 4
        assert int(jnp.max(lo)) <= 15 and int(jnp.max(hi)) <= 15

    def test_constant_rows_no_nan(self):
        w = jnp.ones((8, 16), dtype=jnp.float32) * 3.0
        qt = quantize(w)
        w2 = dequantize(qt)
        assert not bool(jnp.any(jnp.isnan(w2)))
        assert jnp.max(jnp.abs(w2 - w)) < 0.5
        # zero rows too
        qt0 = quantize(jnp.zeros((4, 16)))
        assert not bool(jnp.any(jnp.isnan(dequantize(qt0))))
        assert jnp.max(jnp.abs(dequantize(qt0))) < 0.5

    def test_zero_point_range(self, rng):
        w = randw(rng, 32, 64) + 5.0  # all-positive rows stress zp clamp
        _, _, zp = quantize_weights(w)
        assert float(jnp.min(zp)) >= 0.0 and float(jnp.max(zp)) <= 15.0


class TestLayouts:
    def test_interleaved_pack_unpack_identity(self, rng):
        q = jnp.asarray(rng.integers(0, 16, (32, 128)), dtype=jnp.uint8)
        assert jnp.array_equal(unpack_interleaved(pack_interleaved(q)), q)

    @pytest.mark.parametrize("block_k", [64, 128, 256])
    def test_block_planar_pack_unpack_identity(self, rng, block_k):
        q = jnp.asarray(rng.integers(0, 16, (16, 512)), dtype=jnp.uint8)
        assert jnp.array_equal(unpack_block_planar(pack_block_planar(q, block_k), block_k), q)

    def test_layout_conversion(self, rng):
        q = jnp.asarray(rng.integers(0, 16, (8, 256)), dtype=jnp.uint8)
        inter = pack_interleaved(q)
        planar = interleaved_to_block_planar(inter, 128)
        assert jnp.array_equal(unpack_block_planar(planar, 128), q)

    def test_layouts_dequantize_identically(self, rng):
        w = randw(rng, 64, 256)
        a = dequantize(quantize(w, layout="interleaved"))
        b = dequantize(quantize(w, layout="block_planar"))
        assert jnp.array_equal(a, b)

    def test_planar_groups_roundtrip_and_dequant(self, rng):
        """planar_groups is a pure reorder of planar bytes: [Gh, N, gs]
        round-trips to planar exactly, dequantizes identically, and works
        over stacked expert dims."""
        from fused4bit.quant.core import (
            planar_groups_to_planar,
            planar_to_planar_groups,
        )

        for shape in [(16, 512), (3, 16, 512)]:  # incl. expert-stacked
            w = randw(rng, *shape)
            qp = quantize(w, granularity="per_group", group_size=128,
                          layout="planar")
            qg = quantize(w, granularity="per_group", group_size=128,
                          layout="planar_groups")
            assert qg.packed.shape == shape[:-2] + (2, shape[-2], 128)
            assert jnp.array_equal(
                planar_groups_to_planar(qg.packed), qp.packed
            )
            assert jnp.array_equal(
                planar_to_planar_groups(qp.packed, 128), qg.packed
            )
            assert jnp.array_equal(dequantize(qp), dequantize(qg))

    def test_planar_groups_requires_per_group(self, rng):
        w = randw(rng, 8, 256)
        with pytest.raises(ValueError):
            quantize(w, granularity="per_row", layout="planar_groups")

    def test_choose_block_k(self):
        assert choose_block_k(4096) == 512
        assert choose_block_k(11008) == 256
        assert choose_block_k(14336) == 512
        assert choose_block_k(100) == 100

    def test_reference_interleave_semantics(self):
        # Byte layout must match the reference exactly: values [5, 12] at
        # indices [0, 1] pack to 0xC5 (reference python/quantize.py:28-31).
        q = jnp.asarray([[5, 12]], dtype=jnp.uint8)
        packed = pack_interleaved(q)
        assert int(packed[0, 0]) == 0xC5


class TestReferenceLinear:
    def test_matches_manual(self, rng):
        w = randw(rng, 64, 128)
        x = randw(rng, 128)
        packed, s, z = quantize_weights(w)
        got = reference_quantized_linear(x, packed, s, z)
        want = x @ dequantize_weights(packed, s, z).T
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    def test_batched_shape(self, rng):
        w = randw(rng, 64, 128)
        x = randw(rng, 4, 128)
        packed, s, z = quantize_weights(w)
        assert reference_quantized_linear(x, packed, s, z).shape == (4, 64)

    def test_quality_vs_fp32(self, rng):
        w = randw(rng, 256, 512)
        x = randw(rng, 512)
        exact = x @ w.T
        qt = quantize(w)
        approx = reference_linear_qt(x, qt)
        err = jnp.mean(jnp.abs(exact - approx))
        cos = jnp.dot(exact, approx) / (jnp.linalg.norm(exact) * jnp.linalg.norm(approx))
        assert float(err) < 3.0
        assert float(cos) > 0.95

    def test_memory_reduction(self, rng):
        # Reference asserts >= 7.5x vs fp32 incl. scales/zp
        # (tests/test_benchmark.py:55-76).
        w = randw(rng, 4096, 4096)
        qt = quantize(w)
        assert qt.memory_reduction_vs(jnp.float32) >= 7.5

    def test_quantized_tensor_is_pytree(self, rng):
        qt = quantize(randw(rng, 16, 32))
        leaves = jax.tree_util.tree_leaves(qt)
        assert len(leaves) == 3
        qt2 = jax.tree_util.tree_map(lambda x: x, qt)
        assert isinstance(qt2, QuantizedTensor)
        assert qt2.block_k == qt.block_k


class TestPadRows:
    """pad_rows: conversion-time row padding for kernel-best tiles."""

    def test_padded_dequant_matches_with_zero_tail(self, rng):
        from fused4bit.quant import pad_rows

        w = randw(rng, 300, 64)
        for kwargs in (
            dict(granularity="per_row", layout="planar"),
            dict(granularity="per_group", group_size=16, layout="planar"),
        ):
            qt = quantize(w, **kwargs)
            qp = pad_rows(qt, 128)
            assert qp.shape == (384, 64)
            wd = dequantize(qp)
            np.testing.assert_allclose(
                np.asarray(wd[:300]), np.asarray(dequantize(qt))
            )
            assert float(jnp.max(jnp.abs(wd[300:]))) == 0.0

    def test_noop_when_aligned(self, rng):
        from fused4bit.quant import pad_rows

        qt = quantize(randw(rng, 256, 64))
        assert pad_rows(qt, 128) is qt

    def test_quantized_linear_padded_for_kernel(self, rng):
        from fused4bit.layers.linear import QuantizedLinear

        w = randw(rng, 300, 512)
        x = jnp.asarray(rng.normal(size=(4, 512)), jnp.float32)
        lin = QuantizedLinear.from_dense(w, bias=jnp.ones((300,)))
        pad = lin.padded_for_kernel()
        assert pad.out_dim == 300
        assert pad.weight.out_dim % 128 == 0
        np.testing.assert_allclose(
            np.asarray(pad(x)), np.asarray(lin(x)), rtol=1e-5, atol=1e-5
        )
