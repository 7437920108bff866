"""Emulated FP4 (E2M1) quantization.

Counterpart of the reference's FP4 grouped-GEMM experiment
(`benchmark/moe_grouped_gemm/grouped_gemm_fp4.py`). The
reference *simulates* FP4 — it admits "not real E2M1 packing" (`...:64-65`)
and stores int8 codes from ``round(x*2.5)`` clamped to ±15, which is a
uniform grid, not E2M1. This implementation is emulated too (no packed 4-bit
storage; XLA int4 storage is unusable on the current backend) but quantizes
to the **true E2M1 value grid** ±{0, .5, 1, 1.5, 2, 3, 4, 6}, so the error
characteristics match what Blackwell/NVFP4-class hardware would give.

Per-tensor absmax scaling to the ±6 E2M1 range, mirroring the reference's
``quantize_fp4`` (`...:32-67`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["FP4Tensor", "quantize_fp4", "dequantize_fp4", "E2M1_VALUES"]

# The 8 non-negative E2M1 magnitudes; full grid is ± these.
E2M1_VALUES = jnp.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FP4Tensor:
    """E2M1-coded tensor: uint8 codes (sign<<3 | magnitude index) + scale."""

    codes: jnp.ndarray          # [..., N, K] u8, 4 significant bits (emulated)
    scale: jnp.ndarray          # per-tensor (or per-leading-dim) f32
    shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def nbytes_ideal(self) -> int:
        """Bytes a real packed-FP4 store would take (what the emulation models)."""
        n = 1
        for d in self.shape:
            n *= d
        return n // 2 + self.scale.size * 4


def quantize_fp4(w: jnp.ndarray) -> FP4Tensor:
    """Round to the nearest E2M1 grid point after absmax scaling to ±6.

    Leading dims (e.g. experts) each get their own scalar scale, like the
    reference's per-tensor scale (`grouped_gemm_fp4.py:38-44`).
    """
    w = w.astype(jnp.float32)
    reduce_axes = tuple(range(w.ndim - 2, w.ndim))
    absmax = jnp.max(jnp.abs(w), axis=reduce_axes)
    scale = jnp.clip(absmax, min=1e-8) / 6.0
    ws = w / scale[(...,) + (None,) * 2]
    sign = (ws < 0).astype(jnp.uint8)
    mag = jnp.abs(ws)
    # nearest of the 8 magnitudes
    dist = jnp.abs(mag[..., None] - E2M1_VALUES)
    idx = jnp.argmin(dist, axis=-1).astype(jnp.uint8)
    codes = (sign << 3) | idx
    return FP4Tensor(codes=codes, scale=scale.astype(jnp.float32), shape=tuple(w.shape))


def dequantize_fp4(t: FP4Tensor, dtype=jnp.float32) -> jnp.ndarray:
    mag = E2M1_VALUES[(t.codes & 0x7).astype(jnp.int32)]
    sign = jnp.where((t.codes >> 3) > 0, -1.0, 1.0)
    return (sign * mag * t.scale[(...,) + (None,) * 2]).astype(dtype)


def fp4_matmul(x: jnp.ndarray, t: FP4Tensor, dtype=None) -> jnp.ndarray:
    """Dequantize-then-matmul (the reference's forward, `...:75-112`)."""
    w = dequantize_fp4(t, dtype=jnp.float32)
    out = jnp.matmul(x.astype(jnp.float32), jnp.swapaxes(w, -1, -2))
    return out.astype(dtype or x.dtype)
