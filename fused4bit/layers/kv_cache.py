"""INT4-quantized KV cache (sequence-pair-packed layout).

New capability the reference only *motivates* ("KV cache quantization → 8x
memory savings", `README.md:112`;
`run_honest_benchmark.py:162`) but never implements — there is no attention
code in the reference at all (SURVEY.md §5 long-context row). Quantization
is the weight quantizer's affine spec, per (head, position) vector over
head_dim.

Layout (per layer):
  k_packed/v_packed: [B, H_kv, S/2, D] u8 — byte (s', d) holds position
    2s' in its LOW nibble and position 2s'+1, XOR 8, in its HIGH nibble
    ("pair-packed": the nibble pair spans two SEQUENCE positions of the
    same channel, not two channels of one position).
  k_scale/k_zp/...:  [B, H_kv, S] f32 (per position, unpacked)

Why pair-packed: the attention kernel reads K/V tiles as [S_tile/2, D]
u8 blocks whose rows are whole head vectors. Flash attention doesn't care that a tile's rows arrive as
(even positions, odd positions): softmax and the PV contraction are
permutation-invariant over s as long as the causal mask uses each row's
true position — which the kernel reconstructs as tile_start + 2*i (+1).

Static S_max ring keeps everything jit-friendly; `lengths` tracks per-slot
fill. Appends at ODD start positions or odd lengths read-modify-write the
boundary byte (mask one nibble, or-in the other) — a single writer, no
atomics needed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["QuantizedKVCache", "quantize_kv", "dequantize_kv"]

_MAXQ = 15.0


def _affine(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-vector scale/zp + integer codes q in [0, 15]. x: [..., D]."""
    x = x.astype(jnp.float32)
    mn = jnp.min(x, axis=-1)
    mx = jnp.max(x, axis=-1)
    scale = (mx - mn) / _MAXQ
    scale = jnp.where(mx == mn, jnp.clip(jnp.abs(mx), min=1.0) / _MAXQ, scale)
    scale = jnp.clip(scale, min=1e-8)
    zp = jnp.clip(jnp.round(-mn / scale), 0.0, _MAXQ)
    q = jnp.clip(jnp.round(x / scale[..., None] + zp[..., None]), 0, _MAXQ)
    return q.astype(jnp.uint8), scale.astype(jnp.float32), zp.astype(jnp.float32)


def quantize_kv(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Quantize [..., D] vectors to planar-packed INT4 (along D) with
    per-vector scale/zp — the generic per-vector packer (weight spec);
    the cache itself uses the sequence-pair packing below.
    """
    q, scale, zp = _affine(x)
    half = x.shape[-1] // 2
    packed = (((q[..., half:] ^ 0x8) << 4) | q[..., :half]).astype(jnp.uint8)
    return packed, scale, zp


def dequantize_kv(packed, scale, zp, dtype=jnp.float32) -> jnp.ndarray:
    """Inverse of :func:`quantize_kv`: [..., D/2] u8 -> [..., D]."""
    lo = (packed & 0x0F).astype(jnp.float32)
    hi = ((packed >> 4) ^ 0x8).astype(jnp.float32)
    q = jnp.concatenate([lo, hi], axis=-1)
    return ((q - zp[..., None]) * scale[..., None]).astype(dtype)


def _pack_pairs(q: jnp.ndarray) -> jnp.ndarray:
    """[B, H, T(even), D] u4-codes -> [B, H, T/2, D] bytes (lo=even pos,
    hi=odd pos XOR 8)."""
    b, h, t, d = q.shape
    pairs = q.reshape(b, h, t // 2, 2, d)
    return (((pairs[:, :, :, 1] ^ 0x8) << 4) | pairs[:, :, :, 0]).astype(
        jnp.uint8
    )


def _unpack_pairs(packed: jnp.ndarray) -> jnp.ndarray:
    """[B, H, S/2, D] bytes -> [B, H, S, D] u4-codes (interleaved back)."""
    b, h, s2, d = packed.shape
    lo = (packed & 0x0F).astype(jnp.uint8)
    hi = ((packed >> 4) ^ 0x8).astype(jnp.uint8)
    return jnp.stack([lo, hi], axis=3).reshape(b, h, s2 * 2, d)


def _merge_packed(buf: jnp.ndarray, q: jnp.ndarray, s) -> jnp.ndarray:
    """Insert T new position codes into a pair-packed buffer at position s.

    buf: [H, S/2, D] u8 pair-packed; q: [H, T, D] u4 codes; s: scalar i32.
    Returns the updated buffer. Odd alignment and odd T read-modify-write the
    boundary bytes (mask one nibble, or-in the other) — shared by the
    contiguous cache (one buffer per batch row) and the paged cache (one
    buffer per page; the caller guarantees [s, s+T) lies inside the buffer).
    """
    h, s2, d = buf.shape
    t_new = q.shape[1]
    # Touch byte rows [s//2, s//2 + t2) with t2 = T//2 + 1 (static): enough
    # for any alignment/parity combination.
    t2 = min(t_new // 2 + 1, s2)
    # clamp the window like dynamic_slice will, and derive positions from
    # the CLAMPED start so boundary writes stay consistent
    r0 = jnp.minimum(s // 2, s2 - t2)
    cur = jax.lax.dynamic_slice(buf, (0, r0, 0), (h, t2, d))
    # position of each (byte row, nibble): p = 2*(r0 + i) + n
    i = jnp.arange(t2)[:, None]                  # [t2, 1]
    n = jnp.arange(2)[None, :]                   # [1, 2]
    pos = 2 * (r0 + i) + n                       # [t2, 2]
    idx = jnp.clip(pos - s, 0, t_new - 1)        # index into q
    valid = (pos >= s) & (pos < s + t_new)       # [t2, 2]
    newq = q[:, idx]                             # [H, t2, 2, D]
    cur_lo = cur & 0x0F
    cur_hi = (cur >> 4) ^ 0x8
    lo = jnp.where(valid[None, :, 0, None], newq[:, :, 0], cur_lo)
    hi = jnp.where(valid[None, :, 1, None], newq[:, :, 1], cur_hi)
    merged = (((hi ^ 0x8) << 4) | lo).astype(jnp.uint8)
    return jax.lax.dynamic_update_slice(buf, merged, (0, r0, 0))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedKVCache:
    """Per-layer INT4 KV cache with static capacity and per-slot lengths.

    Per-slot ``lengths`` (rather than one scalar) is what continuous batching
    needs: every batch slot advances independently as requests of different
    lengths come and go (`fused4bit.serving.engine`).
    """

    k_packed: jnp.ndarray   # [B, H, S/2, D] u8 pair-packed
    v_packed: jnp.ndarray
    k_scale: jnp.ndarray    # [B, H, S] f32
    k_zp: jnp.ndarray
    v_scale: jnp.ndarray
    v_zp: jnp.ndarray
    lengths: jnp.ndarray    # [B] i32 — filled positions per slot

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, max_seq: int, head_dim: int):
        if max_seq % 2:
            raise ValueError(f"max_seq={max_seq} must be even (pair packing)")
        z8 = jnp.zeros((batch, num_kv_heads, max_seq // 2, head_dim), jnp.uint8)
        zf = jnp.zeros((batch, num_kv_heads, max_seq), jnp.float32)
        return cls(z8, z8, zf, zf, zf, zf, jnp.zeros((batch,), jnp.int32))

    @property
    def max_seq(self) -> int:
        return self.k_packed.shape[2] * 2

    @property
    def head_dim(self) -> int:
        return self.k_packed.shape[3]

    @property
    def length(self) -> jnp.ndarray:
        """Scalar length when all slots are in lockstep (simple decode)."""
        return jnp.max(self.lengths)

    @property
    def nbytes(self) -> int:
        return sum(
            a.size * a.dtype.itemsize
            for a in (
                self.k_packed, self.v_packed,
                self.k_scale, self.k_zp, self.v_scale, self.v_zp,
            )
        )

    def append(self, k: jnp.ndarray, v: jnp.ndarray, start=None) -> "QuantizedKVCache":
        """Quantize + insert new steps.

        k, v: [B, H, T_new, D]; each batch row b is written at positions
        [start[b], start[b]+T_new) — ``start`` defaults to the row's current
        length (plain append). Odd alignment is handled by nibble-level
        read-modify-write of the boundary bytes.
        """
        b, h, t_new, d = k.shape
        qk, ks, kz = _affine(k)
        qv, vs, vz = _affine(v)
        start = self.lengths if start is None else start

        upd_packed = _merge_packed  # buf [H, S/2, D], q [H, T, D], s scalar

        def upd3(buf, val, s):
            return jax.lax.dynamic_update_slice(buf, val, (0, s))

        kp = jax.vmap(upd_packed)(self.k_packed, qk, start)
        vp = jax.vmap(upd_packed)(self.v_packed, qv, start)
        return QuantizedKVCache(
            k_packed=kp,
            v_packed=vp,
            k_scale=jax.vmap(upd3)(self.k_scale, ks, start),
            k_zp=jax.vmap(upd3)(self.k_zp, kz, start),
            v_scale=jax.vmap(upd3)(self.v_scale, vs, start),
            v_zp=jax.vmap(upd3)(self.v_zp, vz, start),
            lengths=start + t_new,
        )

    def reset_slot(self, slot) -> "QuantizedKVCache":
        """Mark one batch slot empty (its stale data is masked by length)."""
        return dataclasses.replace(
            self, lengths=self.lengths.at[slot].set(0)
        )

    # -- engine seam: single-slot prefill slicing (polymorphic with
    #    PagedKVCache, whose pools are shared across slots) ----------------

    def slice_slot(self, slot) -> "QuantizedKVCache":
        """Batch-1 view of one slot (every array here is batch-major)."""
        return jax.tree.map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, slot, 1, axis=0), self
        )

    def merge_slot(self, part: "QuantizedKVCache", slot) -> "QuantizedKVCache":
        """Write a batch-1 view produced by :meth:`slice_slot` back."""
        return jax.tree.map(
            lambda full, p: jax.lax.dynamic_update_slice_in_dim(
                full, p, slot, axis=0
            ),
            self, part,
        )

    def dequantize(self, dtype=jnp.bfloat16):
        """Full dense K, V: [B, H, S, D] (positions past `length` are junk —
        mask in attention)."""

        def dq(packed, scale, zp):
            q = _unpack_pairs(packed).astype(jnp.float32)
            return ((q - zp[..., None]) * scale[..., None]).astype(dtype)

        k = dq(self.k_packed, self.k_scale, self.k_zp)
        v = dq(self.v_packed, self.v_scale, self.v_zp)
        return k, v
