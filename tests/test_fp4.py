"""Emulated FP4 (E2M1) tests — coverage the reference lacks entirely."""
import jax.numpy as jnp
import numpy as np

from fused4bit.quant.fp4 import (
    E2M1_VALUES,
    dequantize_fp4,
    fp4_matmul,
    quantize_fp4,
)


class TestFP4:
    def test_grid_values_roundtrip_exactly(self):
        # every representable value must survive quantization unchanged
        vals = np.concatenate([np.asarray(E2M1_VALUES), -np.asarray(E2M1_VALUES)])
        w = jnp.asarray(np.tile(vals, (4, 2)), jnp.float32)  # absmax 6 -> scale 1
        t = quantize_fp4(w)
        np.testing.assert_allclose(np.asarray(dequantize_fp4(t)), np.asarray(w))

    def test_roundtrip_error_bounded(self, rng):
        w = jnp.asarray(rng.standard_normal((64, 128)), jnp.float32)
        t = quantize_fp4(w)
        w2 = dequantize_fp4(t)
        # worst relative grid gap is (6-4)/2 / 6 = 1/6 of absmax
        assert float(jnp.max(jnp.abs(w2 - w))) <= float(jnp.max(jnp.abs(w))) / 6 + 1e-6

    def test_codes_are_4bit(self, rng):
        w = jnp.asarray(rng.standard_normal((8, 16)), jnp.float32)
        t = quantize_fp4(w)
        assert int(jnp.max(t.codes)) <= 15

    def test_per_expert_scales(self, rng):
        w = jnp.asarray(rng.standard_normal((4, 8, 16)), jnp.float32)
        w = w.at[2].multiply(100.0)
        t = quantize_fp4(w)
        assert t.scale.shape == (4,)
        rel = jnp.abs(dequantize_fp4(t) - w) / jnp.max(jnp.abs(w), axis=(1, 2))[:, None, None]
        assert float(jnp.max(rel)) < 0.2

    def test_matmul_quality(self, rng):
        w = jnp.asarray(rng.standard_normal((64, 256)), jnp.float32)
        x = jnp.asarray(rng.standard_normal((256,)), jnp.float32)
        t = quantize_fp4(w)
        exact = x @ w.T
        approx = fp4_matmul(x, t)
        cos = jnp.dot(exact, approx) / (jnp.linalg.norm(exact) * jnp.linalg.norm(approx))
        assert float(cos) > 0.95

    def test_ideal_memory(self, rng):
        t = quantize_fp4(jnp.zeros((128, 256)))
        assert t.nbytes_ideal < 128 * 256  # < 1 byte/weight incl. scale
