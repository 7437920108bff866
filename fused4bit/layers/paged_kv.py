"""Paged INT4 KV cache: a shared page pool + per-slot page tables.

The vLLM-style KV memory manager, re-designed for XLA's static-shape
world. The contiguous `QuantizedKVCache` reserves ``num_slots * max_seq``
positions up front — every slot pays for the *longest possible* request.
Here the cache is a pool of fixed-size pages that slots borrow and return:

  k_pool/v_pool : [P, H, page/2, D] u8   pair-packed codes (same nibble
                                         layout as the contiguous cache)
  k_scale/...   : [P, H, page]      f32  per-position affine params
  page_table    : [B, max_pages]    i32  slot -> physical page ids
  lengths       : [B]               i32  filled positions per slot

Memory for a request is its *actual* budget (prompt + max_new_tokens),
rounded up to pages — so a pool sized for the mean request length serves
far more concurrent slots than the contiguous layout, and short requests
stop subsidizing long ones. Pages freed on retirement are reused by the
next admission (the host-side allocator lives in `serving.engine`).

Indirection in the kernel: decode attention never gathers pages into a
contiguous buffer. Each program of the decode kernel reads its tile's
physical page from the slot's table (`ops.decode_attention`); logical
positions come from the tile index, physical pages only decide *where*
each tile's bytes are read from. Everything else in the kernel (masks,
online softmax) is the contiguous kernel's.

Static-shape contract (kept by the serving engine):
* every ``append`` lies inside ONE page: ``start % page + T <= page``.
  Decode steps (T=1) always satisfy it; chunked prefill does whenever
  ``page_size % prefill_bucket == 0`` (bucket-aligned chunk starts).
* unused page-table entries point at page 0 — a valid physical page, so
  any read past a slot's length is well-defined (the kernel skips tiles
  past the length, and the length mask covers the rest).

The reference has no KV cache at all (SURVEY.md §5 long-context row);
this subsystem is north-star serving capability layered on the same
INT4 affine spec as the weights (`python/quantize.py`).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .kv_cache import _affine, _merge_packed, _unpack_pairs

__all__ = ["PagedKVCache"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """INT4 KV cache over a shared page pool (see module docstring)."""

    k_pool: jnp.ndarray      # [P, H, page/2, D] u8 pair-packed
    v_pool: jnp.ndarray
    k_scale: jnp.ndarray     # [P, H, page] f32
    k_zp: jnp.ndarray
    v_scale: jnp.ndarray
    v_zp: jnp.ndarray
    page_table: jnp.ndarray  # [B, max_pages] i32 (unused entries -> 0)
    lengths: jnp.ndarray     # [B] i32

    @classmethod
    def init(
        cls,
        batch: int,
        num_kv_heads: int,
        head_dim: int,
        *,
        num_pages: int,
        page_size: int,
        max_pages_per_slot: int,
    ) -> "PagedKVCache":
        if page_size % 2:
            raise ValueError(f"page_size={page_size} must be even (pair packing)")
        z8 = jnp.zeros(
            (num_pages, num_kv_heads, page_size // 2, head_dim), jnp.uint8
        )
        zf = jnp.zeros((num_pages, num_kv_heads, page_size), jnp.float32)
        return cls(
            k_pool=z8, v_pool=z8,
            k_scale=zf, k_zp=zf, v_scale=zf, v_zp=zf,
            page_table=jnp.zeros((batch, max_pages_per_slot), jnp.int32),
            lengths=jnp.zeros((batch,), jnp.int32),
        )

    # -- geometry -----------------------------------------------------------

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2] * 2

    @property
    def num_pages(self) -> int:
        return self.k_pool.shape[0]

    @property
    def max_pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        """Per-slot logical capacity (table width x page size)."""
        return self.max_pages_per_slot * self.page_size

    @property
    def head_dim(self) -> int:
        return self.k_pool.shape[3]

    @property
    def nbytes(self) -> int:
        return sum(
            a.size * a.dtype.itemsize
            for a in (
                self.k_pool, self.v_pool,
                self.k_scale, self.k_zp, self.v_scale, self.v_zp,
            )
        )

    # -- slot management (host-side allocator calls these) -------------------

    def assign_pages(self, slot: int, pages) -> "PagedKVCache":
        """Point a slot's table at `pages` (list/array of physical ids);
        entries beyond len(pages) are parked at page 0."""
        pages = jnp.asarray(pages, jnp.int32)
        if pages.shape[0] > self.max_pages_per_slot:
            # .at[:n].set silently clamps; refuse loudly instead
            raise ValueError(
                f"{pages.shape[0]} pages exceed the table width "
                f"{self.max_pages_per_slot}"
            )
        row = jnp.zeros((self.max_pages_per_slot,), jnp.int32)
        row = row.at[: pages.shape[0]].set(pages)
        return dataclasses.replace(
            self,
            page_table=self.page_table.at[slot].set(row),
            lengths=self.lengths.at[slot].set(0),
        )

    def reset_slot(self, slot) -> "PagedKVCache":
        """Mark a slot empty (pages are returned by the host allocator)."""
        return dataclasses.replace(
            self,
            lengths=self.lengths.at[slot].set(0),
            page_table=self.page_table.at[slot].set(
                jnp.zeros((self.max_pages_per_slot,), jnp.int32)
            ),
        )

    # -- engine seam: single-slot prefill slicing ----------------------------

    def slice_slot(self, slot) -> "PagedKVCache":
        """Batch-1 view: slice the batch-major arrays, SHARE the pools
        (a batch-1 prefill writes straight into the shared pool through the
        slot's own pages — no other slot maps them)."""
        return dataclasses.replace(
            self,
            page_table=jax.lax.dynamic_slice_in_dim(self.page_table, slot, 1, 0),
            lengths=jax.lax.dynamic_slice_in_dim(self.lengths, slot, 1, 0),
        )

    def merge_slot(self, part: "PagedKVCache", slot) -> "PagedKVCache":
        """Merge a batch-1 view back: pools come from `part` (it wrote
        them), table/length rows are re-inserted."""
        return dataclasses.replace(
            part,
            page_table=jax.lax.dynamic_update_slice_in_dim(
                self.page_table, part.page_table, slot, 0
            ),
            lengths=jax.lax.dynamic_update_slice_in_dim(
                self.lengths, part.lengths, slot, 0
            ),
        )

    # -- data path ------------------------------------------------------------

    def append(self, k: jnp.ndarray, v: jnp.ndarray, start=None) -> "PagedKVCache":
        """Quantize + insert new steps through the page table.

        k, v: [B, H, T, D]; row b writes logical positions
        [start[b], start[b]+T). Contract: each row's write lies inside one
        page (``start % page_size + T <= page_size``) — decode steps and
        bucket-aligned prefill chunks always do (module docstring).

        Distinct slots own distinct pages, so the sequential fold over batch
        rows below has no write conflicts; it exists because the pool is
        *shared* state that a vmap over rows cannot thread.
        """
        b, h, t_new, d = k.shape
        page = self.page_size
        qk, ks, kz = _affine(k)
        qv, vs, vz = _affine(v)
        start = self.lengths if start is None else start
        logical_page = start // page                       # [B]
        pids = jnp.take_along_axis(
            self.page_table, logical_page[:, None], axis=1
        )[:, 0]                                            # [B] physical page
        off = start % page

        def row(c, bi):
            kp, vp, ksc, kzp, vsc, vzp = c
            pid = pids[bi]

            def upd_pool(pool, q):
                buf = jax.lax.dynamic_slice(
                    pool, (pid, 0, 0, 0), (1, h, page // 2, d)
                )[0]
                buf = _merge_packed(buf, q[bi], off[bi])
                return jax.lax.dynamic_update_slice(
                    pool, buf[None], (pid, 0, 0, 0)
                )

            def upd_aff(pool, val):
                cur = jax.lax.dynamic_slice(
                    pool, (pid, 0, 0), (1, h, page)
                )[0]
                cur = jax.lax.dynamic_update_slice(cur, val[bi], (0, off[bi]))
                return jax.lax.dynamic_update_slice(pool, cur[None], (pid, 0, 0))

            return (
                upd_pool(kp, qk), upd_pool(vp, qv),
                upd_aff(ksc, ks), upd_aff(kzp, kz),
                upd_aff(vsc, vs), upd_aff(vzp, vz),
            )

        pools = (
            self.k_pool, self.v_pool,
            self.k_scale, self.k_zp, self.v_scale, self.v_zp,
        )
        pools = jax.lax.fori_loop(
            0, b, lambda i, c: row(c, i), pools
        ) if b > 1 else row(pools, 0)
        kp, vp, ksc, kzp, vsc, vzp = pools
        return dataclasses.replace(
            self,
            k_pool=kp, v_pool=vp,
            k_scale=ksc, k_zp=kzp, v_scale=vsc, v_zp=vzp,
            lengths=start + t_new,
        )

    def dequantize(self, dtype=jnp.bfloat16):
        """Logical dense K, V: [B, H, max_seq, D] gathered through the page
        table (positions past `lengths` are junk — mask in attention). The
        golden/debug path; the fused kernel never materializes this."""
        table = self.page_table  # [B, MP]

        def gather(pool, scale, zp):
            # pool[table]: [B, MP, H, page/2, D] -> [B, H, MP*page/2, D]
            pg = pool[table]
            b, mp, h, p2, d = pg.shape
            pg = pg.transpose(0, 2, 1, 3, 4).reshape(b, h, mp * p2, d)
            q = _unpack_pairs(pg).astype(jnp.float32)
            sc = scale[table].transpose(0, 2, 1, 3).reshape(b, h, -1)
            z = zp[table].transpose(0, 2, 1, 3).reshape(b, h, -1)
            return ((q - z[..., None]) * sc[..., None]).astype(dtype)

        k = gather(self.k_pool, self.k_scale, self.k_zp)
        v = gather(self.v_pool, self.v_scale, self.v_zp)
        return k, v
