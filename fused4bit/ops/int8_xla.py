"""INT4-valued weights in int8 containers, executed by XLA integer matmuls.

Storing the SAME int4 weights zero-point-shifted into i8 containers (2x the
packed size, still 2x smaller than bf16) lets XLA's integer matmul do the
streaming:

    value = (q - zp) * s,   q - zp in [-15, 15]  ->  i8 exactly

    y = (x_q @ w8^T) * s_x * s_w        (int32 accumulate, exact)

with per-token symmetric int8 activation quantization; the weights are the
same int4 values as every other path. `models.transformer.as_xla_turbo`
converts a whole model (resident i8 copies), `as_u4_turbo` unpacks a
transient i8 copy per call at prefill sizes and keeps packed residency.
Whether either beats the fused INT4 kernels on the GPU is not measured.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..quant.core import QuantizedTensor, dequantize

__all__ = [
    "Int8Resident", "to_int8_resident", "int8_linear", "int8_grouped_capacity",
    "int4_linear_transient", "int4_grouped_transient",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8Resident:
    """Int4-valued weights stored zero-point-shifted in i8.

    q8: [..., N, K] i8, values = q - zp in [-15, 15]
    scales: [..., N] f32 (per output row)
    """

    q8: jnp.ndarray
    scales: jnp.ndarray

    @property
    def nbytes(self) -> int:
        return self.q8.size + self.scales.size * self.scales.dtype.itemsize

    @property
    def out_dim(self) -> int:
        return self.q8.shape[-2]

    @property
    def in_dim(self) -> int:
        return self.q8.shape[-1]


def to_int8_resident(qt: QuantizedTensor) -> Int8Resident:
    """Convert packed-u4 per-row weights to the i8-resident form.

    Exact: zp is integer-valued by the quantization spec
    (`python/quantize.py:80-101`), so q - zp is an integer
    in [-15, 15] recovered bit-exactly from dequant / scale.
    """
    if qt.granularity != "per_row":
        raise ValueError("int8-resident conversion requires per_row scales")
    wd = dequantize(qt, dtype=jnp.float32)
    q8 = jnp.round(wd / qt.scales[..., None]).astype(jnp.int8)
    return Int8Resident(q8=q8, scales=qt.scales.astype(jnp.float32))


def _quantize_acts(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    sx = jnp.clip(amax, min=1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    return xq, sx


def int8_linear(x: jnp.ndarray, w: Int8Resident) -> jnp.ndarray:
    """y = x @ dequant(W)^T via int8 dots. x: [..., K] -> [..., N]."""
    xq, sx = _quantize_acts(x)
    acc = jax.lax.dot_general(
        xq, w.q8, (((xq.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * sx * w.scales).astype(x.dtype)


def int8_grouped_capacity(xe: jnp.ndarray, w: Int8Resident) -> jnp.ndarray:
    """Batched per-expert matmul on the capacity layout.

    xe: [E, C, K] (capacity-dispatched tokens), w.q8: [E, N, K].
    Returns [E, C, N].
    """
    xq, sx = _quantize_acts(xe)
    acc = jax.lax.dot_general(
        xq, w.q8, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )
    return (
        acc.astype(jnp.float32) * sx * w.scales[:, None, :]
    ).astype(xe.dtype)


# ---------------------------------------------------------------------------
# Transient-unpack mode: packed-u4 residency + XLA int8 execution
# ---------------------------------------------------------------------------
#
# The int8-RESIDENT mode above wins the compute-bound prefill regime but
# doubles the weights' device-memory footprint — the one cost the whole framework
# exists to avoid. This mode keeps the weights PACKED (true 4-bit residency)
# and, per layer call, unpacks them with XLA elementwise ops into a
# per-layer TRANSIENT i8 tensor that feeds the same integer dot:
#
#     read u4 (0.5x) -> write i8 (1x) -> matmul reads i8 (1x)
#
# At prefill token counts the matmul is compute-bound, so the ~2.5x-of-packed
# elementwise traffic rides XLA's full memory rate and amortizes over E*N*K*T
# MACs; at decode it would dominate, so callers dispatch this path only in
# the prefill regime (the fused Pallas kernels own decode, where packed
# streaming at half the bytes is the whole game). Peak extra memory is ONE
# layer's i8 weights, freed when the layer's matmul completes — vs the
# resident mode's permanent 2x on every layer at once.


def _transient_w8(qt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Planar-packed QuantizedTensor -> (w8 [..., N, K] i8, scales).

    w8 = q - zp in [-15, 15], exact (zp is integer-valued by the quant spec,
    `python/quantize.py:80-101`). XLA materializes w8 once
    per call; the source of truth in device memory stays the packed u4 bytes.
    """
    if qt.layout != "planar":
        raise ValueError("transient unpack requires planar layout")
    from ..quant.core import unpack_planar

    codes = unpack_planar(qt.packed).astype(jnp.int8)  # [..., N, K] in [0,15]
    if qt.granularity == "per_row":
        zp8 = jnp.round(qt.zero_points).astype(jnp.int8)[..., None]
        scales = qt.scales.astype(jnp.float32)
    elif qt.granularity == "per_tensor":
        zp8 = jnp.round(qt.zero_points).astype(jnp.int8)[..., None, None]
        scales = qt.scales.astype(jnp.float32)[..., None]
    else:
        raise ValueError(
            "transient unpack supports per_row/per_tensor (per_group scales "
            "cannot fold past an integer dot; use the Pallas pg kernel)"
        )
    return codes - zp8, scales


def int4_linear_transient(x: jnp.ndarray, qt) -> jnp.ndarray:
    """y = x @ dequant(W)^T with packed-u4 residency and an XLA i8 dot.

    Prefill-regime counterpart of `ops.int4_matmul.int4_matmul_a8`: same
    int8-activation scheme (identical numerics), but the weight stream is
    unpacked by XLA into a transient i8 buffer so the matmul runs at XLA's
    integer-matmul rate.
    """
    w8, ws = _transient_w8(qt)
    xq, sx = _quantize_acts(x)
    acc = jax.lax.dot_general(
        xq, w8, (((xq.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * sx * ws).astype(x.dtype)


def int4_grouped_transient(xe: jnp.ndarray, qt) -> jnp.ndarray:
    """Capacity-layout batched expert matmul with packed-u4 residency.

    xe: [E, C, K]; qt: planar QuantizedTensor over [E, N, K].
    Returns [E, C, N]. The MoE prefill analogue of `int8_grouped_capacity`.
    """
    w8, ws = _transient_w8(qt)  # [E, N, K], [E, N] (or [E, 1] per_tensor)
    xq, sx = _quantize_acts(xe)
    acc = jax.lax.dot_general(
        xq, w8, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * sx * ws[:, None, :]).astype(xe.dtype)
