"""Golden-reference quantized linear (pure jnp, runs on any backend).

Counterpart of the reference's CPU oracle
`reference_quantized_linear` (`python/quantize.py:176-202`):
dequantize the full weight matrix, then a dense matmul. Slow but obviously
correct — the oracle the Pallas kernels are validated against (same role the
CPU path plays for the CUDA kernel in `tests/test_correctness.py`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .core import QuantizedTensor, dequantize, dequantize_weights

# The oracle must not inherit the backend's default (possibly bf16-reduced)
# matmul precision — a golden reference computes in full f32.
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["reference_quantized_linear", "reference_linear_qt"]


def reference_quantized_linear(x, packed_weights, scales, zero_points):
    """Reference-signature oracle: ``x @ dequant(W)^T``.

    Args mirror the reference (`python/quantize.py:176-195`):
      x:              [K] or [..., K] activations
      packed_weights: [N, K/2] uint8, interleaved layout
      scales / zero_points: [N] float32
    Returns [N] or [..., N].
    """
    w = dequantize_weights(packed_weights, scales, zero_points)
    return jnp.matmul(x.astype(jnp.float32), w.T, precision=_HIGHEST)


def reference_linear_qt(x, qt: QuantizedTensor, dtype=jnp.float32):
    """Oracle for any QuantizedTensor layout/granularity: dequant + matmul."""
    w = dequantize(qt, dtype=jnp.float32)
    return jnp.matmul(
        x.astype(jnp.float32), jnp.swapaxes(w, -1, -2), precision=_HIGHEST
    ).astype(dtype)
