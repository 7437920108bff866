"""INT4 weight quantization core (pure JAX).

Implements the quantization spec of the reference library
(`python/quantize.py:38-124`), with layouts for the fused kernels:

* **Asymmetric affine quantization** to ``[0, 2^bits - 1]``:

  - quantize:   ``q = clamp(round(w / scale + zero_point), 0, 15)``
  - dequantize: ``w = (q - zero_point) * scale``
  - ``scale = (max - min) / 15``; ``zero_point = clamp(round(-min/scale), 0, 15)``
  - constant-row guard: ``scale = clamp(|max|, 1) / 15`` with a 1e-8 floor
    (reference `python/quantize.py:80-101`).

* **Granularities** (the reference ships two of these; per-group is the
  natural superset and is standard for production INT4):

  - ``per_row``:    one (scale, zp) per output row — reference linear path
                    (`python/quantize.py:73-74`).
  - ``per_tensor``: a single scalar (scale, zp) — reference MoE path
                    (`python/moe_int4_module.py:44-54`).
  - ``per_group``:  one (scale, zp) per contiguous group of ``group_size``
                    input columns within a row.

* **Packing layouts** — two nibbles per uint8 byte:

  - ``interleaved``: byte j of a row holds columns (2j, 2j+1) as
    ``(odd << 4) | even`` — bit-exact with the reference
    (`python/quantize.py:120-122`). Kept for parity/interop tests and
    checkpoint compatibility.
  - ``block_planar``: within each contiguous block of ``block_k`` columns,
    byte j holds columns (j, j + block_k/2) as ``(hi << 4) | lo``. Unpacking a
    block is then ``concat([packed & 0xF, packed >> 4], axis=-1)`` — two
    contiguous halves instead of an even/odd interleave.
  - ``planar``: whole-row planar with the XOR-8 high nibble (see
    :func:`pack_planar`) — the per-row fused kernels' layout.
  - ``planar_groups``: planar bytes reordered group-major
    ``[..., Gh, N, group_size]`` (see :func:`planar_to_planar_groups`) —
    each scale group's bytes contiguous; the kernels read either planar
    layout.

All functions are shape-polymorphic over leading batch dims of the weight
(e.g. stacked expert weights ``[E, N, K]``) — reductions/packing always act on
the last axis, mirroring how the reference stacks MoE expert weights
(`python/moe_int4_module.py:96-105`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "pad_rows",
    "quantize_weights",
    "dequantize_weights",
    "pack_interleaved",
    "unpack_interleaved",
    "pack_block_planar",
    "unpack_block_planar",
    "pack_planar",
    "unpack_planar",
    "interleaved_to_planar",
    "interleaved_to_block_planar",
    "planar_to_planar_groups",
    "planar_groups_to_planar",
    "choose_block_k",
    "DEFAULT_BLOCK_K",
]

Granularity = Literal["per_row", "per_tensor", "per_group"]
Layout = Literal["interleaved", "block_planar", "planar", "planar_groups"]

# Canonical kernel k-tile. Both the packer and the Pallas kernel agree on this
# blocking so a packed k-tile unpacks to a *contiguous* range of input columns.
DEFAULT_BLOCK_K = 512


def choose_block_k(k: int, preferred: int = DEFAULT_BLOCK_K) -> int:
    """Largest block_k <= preferred that divides k (k must be even).

    Model dims are typically multiples of 256 (4096, 11008, 14336, ...); we
    pick the largest power-of-two-ish tile that divides K so the Pallas grid
    has no remainder tiles.
    """
    if k % 2 != 0:
        raise ValueError(f"input dim must be even for nibble packing, got {k}")
    for cand in (preferred, 1024, 512, 256, 128):
        if cand <= preferred and k % cand == 0:
            return cand
    # Fall back to the whole row (always even).
    return k


# ---------------------------------------------------------------------------
# Scale / zero-point computation
# ---------------------------------------------------------------------------


def _affine_params(w: jnp.ndarray, axis, keepdims: bool, max_val: int):
    """scale/zp over `axis` with the reference's constant-row guard."""
    w_min = jnp.min(w, axis=axis, keepdims=keepdims)
    w_max = jnp.max(w, axis=axis, keepdims=keepdims)
    scales = (w_max - w_min) / max_val
    # Constant-slice guard (reference python/quantize.py:85-94): a constant
    # slice would give scale 0 → div-by-zero. Use clamp(|max|, 1)/max_val.
    constant = w_max == w_min
    safe = jnp.where(constant, jnp.clip(jnp.abs(w_max), min=1.0) / max_val, scales)
    safe = jnp.clip(safe, min=1e-8)
    zp = jnp.round(-w_min / safe)
    zp = jnp.clip(zp, 0.0, float(max_val))
    return safe.astype(jnp.float32), zp.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Packing / unpacking
# ---------------------------------------------------------------------------


def pack_interleaved(q: jnp.ndarray) -> jnp.ndarray:
    """Pack uint8 nibble values [..., K] -> [..., K/2], reference layout.

    Byte j = (q[..., 2j+1] << 4) | q[..., 2j]  (reference
    `python/quantize.py:120-122`: even index -> low nibble, odd -> high).
    """
    even = q[..., 0::2]
    odd = q[..., 1::2]
    return ((odd << 4) | even).astype(jnp.uint8)


def unpack_interleaved(packed: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`pack_interleaved`: [..., K/2] u8 -> [..., K] u8."""
    low = packed & 0x0F
    high = packed >> 4
    # Interleave even/odd back: stack on a new trailing axis then flatten.
    out = jnp.stack([low, high], axis=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_block_planar(q: jnp.ndarray, block_k: int) -> jnp.ndarray:
    """Pack nibble values [..., K] -> [..., K/2] in the block-planar layout.

    Within each block of ``block_k`` columns, byte j holds columns
    (j, j + block_k/2): low nibble = first half of the block, high nibble =
    second half. Unpacking a packed k-tile of ``block_k/2`` bytes is then a
    concat of two contiguous halves — no lane interleave.
    """
    *lead, k = q.shape
    if k % block_k != 0:
        raise ValueError(f"K={k} not divisible by block_k={block_k}")
    half = block_k // 2
    blocks = q.reshape(*lead, k // block_k, 2, half)
    lo = blocks[..., 0, :]
    hi = blocks[..., 1, :]
    packed = ((hi << 4) | lo).astype(jnp.uint8)
    return packed.reshape(*lead, k // 2)


def unpack_block_planar(packed: jnp.ndarray, block_k: int) -> jnp.ndarray:
    """Inverse of :func:`pack_block_planar`: [..., K/2] u8 -> [..., K] u8."""
    *lead, kh = packed.shape
    half = block_k // 2
    if kh % half != 0:
        raise ValueError(f"packed dim {kh} not divisible by block_k/2={half}")
    blocks = packed.reshape(*lead, kh // half, half)
    lo = blocks & 0x0F
    hi = blocks >> 4
    out = jnp.stack([lo, hi], axis=-2)  # [..., nblocks, 2, half]
    return out.reshape(*lead, kh * 2)


def interleaved_to_block_planar(packed: jnp.ndarray, block_k: int) -> jnp.ndarray:
    """Re-pack reference-layout bytes into the block-planar layout."""
    return pack_block_planar(unpack_interleaved(packed), block_k)


def pack_planar(q: jnp.ndarray) -> jnp.ndarray:
    """Pack nibbles [..., K] -> [..., K/2] in the Pallas kernel layout.

    Whole-row planar: byte c holds q[..., c] in the low nibble and
    q[..., c + K/2] — XOR 8 — in the high nibble (the XOR folds the
    offset-binary high nibble into two's complement: ``p & 0xF0``
    reinterpreted as int8 equals ``16 * (q_hi - 8)``). A K step of the
    kernel reads one contiguous byte tile and unpacks both halves of its
    columns with ``p & 0xF`` and ``(p >> 4) ^ 8``.
    """
    *lead, k = q.shape
    if k % 2 != 0:
        raise ValueError(f"K={k} must be even")
    half = k // 2
    lo = q[..., :half]
    hi = q[..., half:] ^ 0x8
    return ((hi << 4) | lo).astype(jnp.uint8)


def unpack_planar(packed: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`pack_planar`: [..., K/2] u8 -> [..., K] u8."""
    lo = packed & 0x0F
    hi = (packed >> 4) ^ 0x8
    return jnp.concatenate([lo, hi], axis=-1)


def interleaved_to_planar(packed: jnp.ndarray) -> jnp.ndarray:
    """Re-pack reference-layout bytes into the kernels' planar layout."""
    return pack_planar(unpack_interleaved(packed))


def planar_to_planar_groups(packed: jnp.ndarray, group_size: int) -> jnp.ndarray:
    """Reorder planar bytes group-major: [..., N, K/2] -> [..., Gh, N, gs].

    Same bytes as planar, one-time reorder at pack time, so that each scale
    group's bytes are contiguous across rows (the kernels read both planar
    layouts, one group per K step). Each byte still
    holds (lo-half column c, XOR-8 hi-half column c + K/2): group g of the
    LO half and group g of the HI half share slab [g] along the leading axis.
    """
    *lead, n, k_half = packed.shape
    if k_half % group_size != 0:
        raise ValueError(f"K/2={k_half} not divisible by group_size={group_size}")
    gh = k_half // group_size
    p3 = packed.reshape(*lead, n, gh, group_size)
    return jnp.moveaxis(p3, -2, -3)


def planar_groups_to_planar(packed3: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`planar_to_planar_groups`."""
    *lead, gh, n, gs = packed3.shape
    return jnp.moveaxis(packed3, -3, -2).reshape(*lead, n, gh * gs)


# ---------------------------------------------------------------------------
# QuantizedTensor pytree
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """An INT4-packed tensor plus its dequantization metadata.

    Fields
    ------
    packed:       uint8 [..., N, K/2] — two nibbles per byte.
    scales:       float32 — per_row: [..., N]; per_tensor: [...]-scalar
                  broadcastable; per_group: [..., N, K/group_size].
    zero_points:  float32 — same shape as scales.
    Static metadata (hashable aux data): logical shape, granularity, layout,
    block_k (kernel tile for block_planar), group_size (per_group), bits.
    """

    packed: jnp.ndarray
    scales: jnp.ndarray
    zero_points: jnp.ndarray
    shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    granularity: str = dataclasses.field(metadata=dict(static=True))
    layout: str = dataclasses.field(metadata=dict(static=True))
    block_k: int = dataclasses.field(metadata=dict(static=True))
    group_size: int = dataclasses.field(metadata=dict(static=True), default=0)
    bits: int = dataclasses.field(metadata=dict(static=True), default=4)

    @property
    def out_dim(self) -> int:
        return self.shape[-2]

    @property
    def in_dim(self) -> int:
        return self.shape[-1]

    @property
    def nbytes(self) -> int:
        """Total device bytes (packed weights + scales + zero points)."""
        return int(
            self.packed.size * self.packed.dtype.itemsize
            + self.scales.size * self.scales.dtype.itemsize
            + self.zero_points.size * self.zero_points.dtype.itemsize
        )

    def memory_reduction_vs(self, dtype=jnp.float32) -> float:
        dense = 1
        for d in self.shape:
            dense *= d
        dense *= jnp.dtype(dtype).itemsize
        return dense / self.nbytes


# ---------------------------------------------------------------------------
# High-level quantize / dequantize
# ---------------------------------------------------------------------------


def quantize(
    w: jnp.ndarray,
    *,
    bits: int = 4,
    granularity: Granularity = "per_row",
    layout: Layout = "planar",
    group_size: int = 128,
    block_k: Optional[int] = None,
) -> QuantizedTensor:
    """Quantize a weight tensor [..., N, K] to packed INT4.

    The reference equivalent is ``quantize_weights`` for ``per_row``
    (`python/quantize.py:38-124`) and ``quantize_weights_moe`` for
    ``per_tensor`` (`python/moe_int4_module.py:19-80`).
    """
    if w.ndim < 2:
        raise ValueError("weight must be at least 2D [..., out_dim, in_dim]")
    k = w.shape[-1]
    if k % 2 != 0:
        raise ValueError("input_dim must be even for nibble packing")
    max_val = (1 << bits) - 1
    w = w.astype(jnp.float32)

    if granularity == "per_row":
        scales, zp = _affine_params(w, axis=-1, keepdims=False, max_val=max_val)
        s_b, z_b = scales[..., None], zp[..., None]
    elif granularity == "per_tensor":
        # Reduce over the trailing (N, K) matrix; leading dims (e.g. experts)
        # each get their own scalar — matches the reference MoE quantizer
        # which computes one scale per expert (`python/moe_int4_module.py:44-50`).
        scales, zp = _affine_params(w, axis=(-2, -1), keepdims=False, max_val=max_val)
        s_b, z_b = scales[..., None, None], zp[..., None, None]
    elif granularity == "per_group":
        if k % group_size != 0:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        wg = w.reshape(*w.shape[:-1], k // group_size, group_size)
        scales, zp = _affine_params(wg, axis=-1, keepdims=False, max_val=max_val)
        s_b = jnp.repeat(scales, group_size, axis=-1)
        z_b = jnp.repeat(zp, group_size, axis=-1)
    else:
        raise ValueError(f"unknown granularity {granularity!r}")

    q = jnp.round(w / s_b + z_b)
    q = jnp.clip(q, 0, max_val).astype(jnp.uint8)

    if layout == "interleaved":
        bk = block_k or 0
        packed = pack_interleaved(q)
    elif layout == "planar":
        bk = k
        packed = pack_planar(q)
    elif layout == "block_planar":
        # Default: fully planar (block_k = K) — low nibbles hold columns
        # [0, K/2), high nibbles [K/2, K). The Pallas kernel requires this:
        # any contiguous byte-column tile then maps to two contiguous
        # q-column ranges, so tiling K never forces a lane interleave.
        bk = block_k or k
        if granularity == "per_group" and bk % group_size != 0 and group_size % bk != 0:
            raise ValueError(
                f"block_k={bk} and group_size={group_size} must nest"
            )
        packed = pack_block_planar(q, bk)
    elif layout == "planar_groups":
        if granularity != "per_group":
            raise ValueError("planar_groups layout requires per_group granularity")
        if (k // 2) % group_size != 0:
            raise ValueError(
                f"group_size={group_size} must divide K/2={k // 2} "
                "(groups may not straddle the planar halves)"
            )
        bk = k
        packed = planar_to_planar_groups(pack_planar(q), group_size)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    return QuantizedTensor(
        packed=packed,
        scales=scales,
        zero_points=zp,
        shape=tuple(w.shape),
        granularity=granularity,
        layout=layout,
        block_k=bk,
        group_size=group_size if granularity == "per_group" else 0,
        bits=bits,
    )


def pad_rows(qt: QuantizedTensor, multiple: int) -> QuantizedTensor:
    """Pad the output-row dim to a multiple, once, at conversion time.

    With N a multiple of the kernel's n-block every block is full, and the
    forward never pays a per-call padding copy. Padded rows have scale 0
    and dequantize to exact zeros; callers slice outputs back to the
    logical row count (`QuantizedLinear.out_features`).
    """
    n = qt.shape[-2]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return qt
    extra = n_pad - n
    row_axis = qt.packed.ndim - 2
    pw = [(0, 0)] * qt.packed.ndim
    pw[row_axis] = (0, extra)
    if qt.granularity == "per_row":
        ps = [(0, 0)] * qt.scales.ndim
        ps[qt.scales.ndim - 1] = (0, extra)
    elif qt.granularity == "per_group":
        ps = [(0, 0)] * qt.scales.ndim
        ps[qt.scales.ndim - 2] = (0, extra)
    else:  # per_tensor: scalar scale broadcasts over padded rows (q == zp
        # after zero-padding packed only if zp==0; pad packed with the zp
        # nibble pattern instead so padded rows still dequantize to zero)
        raise NotImplementedError(
            "pad_rows supports per_row/per_group granularities"
        )
    return dataclasses.replace(
        qt,
        packed=jnp.pad(qt.packed, pw),
        scales=jnp.pad(qt.scales, ps),
        zero_points=jnp.pad(qt.zero_points, ps),
        shape=tuple(qt.shape[:-2]) + (n_pad, qt.shape[-1]),
    )


def _unpack(qt: QuantizedTensor) -> jnp.ndarray:
    if qt.layout == "interleaved":
        return unpack_interleaved(qt.packed)
    if qt.layout == "planar":
        return unpack_planar(qt.packed)
    if qt.layout == "planar_groups":
        return unpack_planar(planar_groups_to_planar(qt.packed))
    return unpack_block_planar(qt.packed, qt.block_k)


def dequantize(qt: QuantizedTensor, dtype=jnp.float32) -> jnp.ndarray:
    """Reconstruct the dense weight [..., N, K] (reference
    `python/quantize.py:127-173`)."""
    q = _unpack(qt).astype(jnp.float32)
    if qt.granularity == "per_row":
        s = qt.scales[..., None]
        z = qt.zero_points[..., None]
    elif qt.granularity == "per_tensor":
        s = qt.scales[..., None, None]
        z = qt.zero_points[..., None, None]
    else:  # per_group
        s = jnp.repeat(qt.scales, qt.group_size, axis=-1)
        z = jnp.repeat(qt.zero_points, qt.group_size, axis=-1)
    return ((q - z) * s).astype(dtype)


# ---------------------------------------------------------------------------
# Reference-signature wrappers (parity with the reference public API)
# ---------------------------------------------------------------------------


def quantize_weights(w: jnp.ndarray, num_bits: int = 4):
    """Reference-compatible entry point (`python/quantize.py:38`).

    Returns ``(packed_uint8 [N, K/2], scales [N], zero_points [N])`` in the
    reference's interleaved layout, bit-exact with the CUDA repo's packing.
    """
    qt = quantize(w, bits=num_bits, granularity="per_row", layout="interleaved")
    return qt.packed, qt.scales, qt.zero_points


def dequantize_weights(packed: jnp.ndarray, scales: jnp.ndarray, zero_points: jnp.ndarray):
    """Reference-compatible entry point (`python/quantize.py:127`)."""
    q = unpack_interleaved(packed).astype(jnp.float32)
    return (q - zero_points[..., None]) * scales[..., None]
