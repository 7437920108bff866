"""Attention over the packed INT4 KV cache.

The capability the reference only motivates ("KV cache quantization -> 8x
memory savings", the reference's `README.md:112`): decode attention that
reads the packed cache (`layers.kv_cache`, `layers.paged_kv`) straight from
device memory and dequantizes in registers, so long-context decode moves 4x
fewer K/V bytes than a bf16 cache.

* **Decode** (one query per slot): a flash-decoding Pallas kernel (Triton
  route). Programs run over (slot, kv head, split of the sequence); each
  walks its split in tiles of ``BLOCK_S`` positions with the online-softmax
  recurrence, and a small XLA combine merges the splits. The cache is
  sequence-pair-packed: a tile arrives as ``[BLOCK_S/2, D]`` bytes whose low
  nibbles are the even positions and whose high nibbles (XOR 8) are the odd
  ones; the kernel scores both halves against the group's query heads, so
  no interleave is ever needed. The paged cache is the same kernel: a
  program reads each tile's physical page from the slot's page table.
* **Prefill** (a chunk of queries): bound by the tensor cores, not by bytes.
  The slot's cache is dequantized and ``jax.nn.dot_product_attention`` runs
  with the causal and length mask.

On the CPU the decode path is plain JAX (dequantize, then the same
``dot_product_attention``), unless a caller asks for the Pallas interpreter.
On an H100 80GB HBM3 (700 W) the decode kernel beat the plain path 1.75x
(1k context) to 3.4x (8k), and 2.7x to 5.2x paged (device time, PERF.md).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import platform

__all__ = [
    "int4_decode_attention", "int4_decode_attention_plain",
    "int4_prefill_attention",
]

_NEG_INF = -1e30
_BLOCK_H = 16      # query rows per program (pl.dot needs >= 16)


def _decode_kernel(
    len_ref,      # [B] i32
    table_ref,    # [B, MP] i32 page table (paged) | unused [1, 1]
    q_ref,        # [B, Hkv, G, D]
    kp_ref,       # contiguous [B, Hkv, S/2, D] u8 | paged [P, Hkv, page/2, D]
    ks_ref, kz_ref,   # contiguous [B, Hkv, S] f32 | paged [P, Hkv, page]
    vp_ref, vs_ref, vz_ref,
    o_ref,        # [NS, B, Hkv, BH, D] f32 partial numerators
    m_ref,        # [NS, B, Hkv, BH] f32 running max
    l_ref,        # [NS, B, Hkv, BH] f32 running denominator
    *,
    groups: int, block_s: int, split_len: int, page: int, paged: bool,
    sm_scale: float,
):
    b, h, sp = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    d = q_ref.shape[-1]
    half = block_s // 2
    length = len_ref[b]
    row_ok = (jnp.arange(_BLOCK_H) < groups)[:, None]
    q = plgpu.load(q_ref.at[b, h, pl.ds(0, _BLOCK_H), :], mask=row_ok,
                   other=0.0)
    q = q.astype(jnp.bfloat16)
    lo_pos = jnp.arange(half) * 2          # tile-relative even positions
    start = sp * split_len
    n_tiles = jnp.clip(pl.cdiv(length - start, block_s), 0,
                       split_len // block_s)

    def tile(t):
        """(page-or-slot index, packed-row offset, position offset)."""
        pos0 = start + t * block_s
        if paged:
            return table_ref[b, pos0 // page], (pos0 % page) // 2, pos0 % page
        return b, pos0 // 2, pos0

    def dequant(codes, s_ref, z_ref, x, p0):
        """Even/odd position halves of a code tile, dequantized: [half, D]."""
        c = codes.astype(jnp.int32)
        out = []
        for nib, off in ((c & 0x0F, 0), ((c >> 4) ^ 0x08, 1)):
            pos = p0 + off + lo_pos         # gather: every other position
            s = plgpu.load(s_ref.at[x, h, pos])
            z = plgpu.load(z_ref.at[x, h, pos])
            out.append(((nib.astype(jnp.float32) - z[:, None]) * s[:, None])
                       .astype(jnp.bfloat16))
        return out

    def body(t, carry):
        acc, m_prev, l_prev = carry
        x, r0, p0 = tile(t)
        rsl = pl.ds(r0, half)
        k_ev, k_od = dequant(plgpu.load(kp_ref.at[x, h, rsl, :]),
                             ks_ref, kz_ref, x, p0)
        v_ev, v_od = dequant(plgpu.load(vp_ref.at[x, h, rsl, :]),
                             vs_ref, vz_ref, x, p0)
        pos = start + t * block_s + lo_pos
        scores = []
        for k_half_tile, shift in ((k_ev, 0), (k_od, 1)):
            sc = pl.dot(q, k_half_tile, trans_b=True) * sm_scale
            ok = (pos + shift < length)[None, :]
            scores.append(jnp.where(ok, sc, _NEG_INF))
        m_new = jnp.maximum(
            m_prev, jnp.maximum(scores[0].max(axis=1), scores[1].max(axis=1))
        )
        alpha = jnp.exp(m_prev - m_new)
        p_ev = jnp.exp(scores[0] - m_new[:, None])
        p_od = jnp.exp(scores[1] - m_new[:, None])
        l_new = alpha * l_prev + p_ev.sum(axis=1) + p_od.sum(axis=1)
        acc = (alpha[:, None] * acc
               + pl.dot(p_ev.astype(jnp.bfloat16), v_ev)
               + pl.dot(p_od.astype(jnp.bfloat16), v_od))
        return acc, m_new, l_new

    acc, m_i, l_i = jax.lax.fori_loop(
        0, n_tiles, body,
        (jnp.zeros((_BLOCK_H, d), jnp.float32),
         jnp.full((_BLOCK_H,), _NEG_INF, jnp.float32),
         jnp.zeros((_BLOCK_H,), jnp.float32)),
    )
    plgpu.store(o_ref.at[sp, b, h], acc)
    plgpu.store(m_ref.at[sp, b, h], m_i)
    plgpu.store(l_ref.at[sp, b, h], l_i)


@functools.partial(
    jax.jit,
    static_argnames=("block_s", "num_splits", "page", "paged", "interpret"),
)
def _decode_call(q4, lengths, table, kp, ks, kz, vp, vs, vz,
                 *, block_s, num_splits, page, paged, interpret):
    b, h_kv, g, d = q4.shape
    s_max = table.shape[1] * page if paged else kp.shape[2] * 2
    split_len = s_max // num_splits
    kernel = functools.partial(
        _decode_kernel, groups=g, block_s=block_s, split_len=split_len,
        page=page, paged=paged, sm_scale=d ** -0.5,
    )
    shape = (num_splits, b, h_kv, _BLOCK_H)
    acc, m, l = pl.pallas_call(
        kernel,
        grid=(b, h_kv, num_splits),
        out_shape=(
            jax.ShapeDtypeStruct(shape + (d,), jnp.float32),
            jax.ShapeDtypeStruct(shape, jnp.float32),
            jax.ShapeDtypeStruct(shape, jnp.float32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="int4_decode_attention",
    )(lengths.astype(jnp.int32), table.astype(jnp.int32), q4,
      kp, ks, kz, vp, vs, vz)
    # combine the splits (flash-decoding): weights exp(m_split - m_max)
    m_max = m.max(axis=0)
    w = jnp.exp(m - m_max[None])
    num = (w[..., None] * acc).sum(axis=0)
    den = jnp.maximum((w * l).sum(axis=0), 1e-30)
    return (num / den[..., None])[:, :, :g]


def _decode_blocks(b: int, h_kv: int, s_max: int, page: int, block_s=None):
    """(block_s, num_splits): tiles of at most 64 positions that divide the
    page (paged) or the cache, and enough splits for the card's 132 SMs."""
    if block_s is None:
        block_s = 64
        while block_s > 2 and (page or s_max) % block_s:
            block_s //= 2
    elif (page or s_max) % block_s:
        raise ValueError(f"block_s={block_s} must divide {page or s_max}")
    n_tiles = s_max // block_s
    splits = 1
    while b * h_kv * splits < 2 * 132 and splits * 2 <= n_tiles and (
        n_tiles % (splits * 2) == 0
    ):
        splits *= 2
    return block_s, splits


def _masked_attention(q, k, v, mask):
    """q [B, T, Hq, D], k/v [B, S, Hkv, D], mask [B, T, S] -> [B, T, Hq, D]."""
    return jax.nn.dot_product_attention(q, k, v, mask=mask[:, None])


def int4_decode_attention_plain(q, cache):
    """The plain version: dequantize the cache (through the page table when
    paged), then ``jax.nn.dot_product_attention`` with the length mask."""
    k, v = cache.dequantize(dtype=q.dtype)                 # [B, Hkv, S, D]
    span = jnp.arange(k.shape[2])
    mask = (span[None, :] < cache.lengths[:, None])[:, None, :]
    out = _masked_attention(
        q[:, None], k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), mask
    )
    return out[:, 0]


def int4_decode_attention(
    q: jnp.ndarray,        # [B, Hq, D] — single decode step (post-RoPE)
    cache,                 # QuantizedKVCache | PagedKVCache (lengths INCLUDE the step)
    *,
    out_dtype=None,
    interpret: Optional[bool] = None,
    block_s: Optional[int] = None,
) -> jnp.ndarray:
    """Attention over the packed INT4 KV cache for one decode step.

    Returns [B, Hq, D]. The current step's K/V must already be appended
    (entry ``length-1`` is the current step, so the mask is ``s < length``).
    ``block_s`` overrides the kernel's tile of positions (it must divide the
    page, or the cache when contiguous).
    """
    b, hq, d = q.shape
    paged = hasattr(cache, "page_table")
    kp = cache.k_pool if paged else cache.k_packed
    h_kv = kp.shape[1]
    g = hq // h_kv
    if g * h_kv != hq:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={h_kv}")
    if g > _BLOCK_H:
        raise ValueError(f"{g} query heads per kv head; the kernel takes <= {_BLOCK_H}")
    out_dtype = out_dtype or q.dtype
    mode = platform.kernel_mode(interpret)
    if mode == "plain":
        return int4_decode_attention_plain(q, cache).astype(out_dtype)
    if paged:
        page, table = cache.page_size, cache.page_table
        ops = (cache.k_pool, cache.k_scale, cache.k_zp,
               cache.v_pool, cache.v_scale, cache.v_zp)
    else:
        page, table = 0, jnp.zeros((1, 1), jnp.int32)
        ops = (cache.k_packed, cache.k_scale, cache.k_zp,
               cache.v_packed, cache.v_scale, cache.v_zp)
    block_s, splits = _decode_blocks(b, h_kv, cache.max_seq, page, block_s)
    if mode == "compiled" and (block_s < 32 or block_s & (block_s - 1)):
        raise ValueError(
            f"page_size={page}: the compiled kernel takes tiles of a power "
            "of two >= 32 positions"
        )
    out = _decode_call(
        q.reshape(b, h_kv, g, d), cache.lengths, table, *ops,
        block_s=block_s, num_splits=splits, page=page, paged=paged,
        interpret=mode == "interpret",
    )
    return out.reshape(b, hq, d).astype(out_dtype)


def int4_prefill_attention(
    q: jnp.ndarray,        # [B, Hq, T, D] — chunk of queries (post-RoPE)
    cache,                 # QuantizedKVCache | PagedKVCache (lengths INCLUDE the T steps)
    starts: jnp.ndarray,   # [B] i32 — position of each row's first query
) -> jnp.ndarray:
    """Chunked prefill attention over the INT4 cache: dequantize the slot's
    cache, then ``jax.nn.dot_product_attention`` with a causal and length
    mask (query t attends to positions <= starts[b] + t). Returns
    [B, Hq, T, D]."""
    t = q.shape[2]
    k, v = cache.dequantize(dtype=q.dtype)                 # [B, Hkv, S, D]
    span = jnp.arange(k.shape[2])
    qpos = starts[:, None] + jnp.arange(t)[None, :]        # [B, T]
    mask = (span[None, None, :] <= qpos[:, :, None]) & (
        span[None, None, :] < cache.lengths[:, None, None]
    )
    out = _masked_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), mask,
    )
    return out.transpose(0, 2, 1, 3)
