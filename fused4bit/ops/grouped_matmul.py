"""Ragged grouped INT4 GEMM (MoE expert compute).

Re-design of the reference's fused MoE CUDA kernel
(`csrc/moe_int4_kernel.cu:17-136`). The reference launches
one thread block per expert from a host loop with a `.item()` device sync
per expert (`...cu:112-132`), and is incorrect for ffn_dim > 256 or
multi-token groups (SURVEY.md §2.1). This op implements the *intended*
semantics — ``out[t] = x[t] @ dequant(W[expert_of(t)])^T`` over
variable-size, tile-aligned token groups — in one launch:

* Tokens arrive sorted by expert with every group padded to a multiple of
  ``tile_m`` (padding rows are zero). The dispatch that produces this layout
  is plain JAX (`fused4bit.layers.moe.dispatch`).
* ``tile_group_ids`` maps each m-tile to its expert. The kernel is the INT4
  linear kernel of `ops.int4_matmul` with ``BLOCK_M = tile_m``: each program
  loads its own expert id and streams that expert's packed weights, so no
  host loop and no per-expert sync.
* The plain path dequantizes the stacked weights and runs
  ``jax.lax.ragged_dot``.

Weights: stacked per-expert [E, N, K], per_row or per_group, planar or
planar_groups layout. Weights the kernel does not take
(`ops.int4_matmul.kernel_takes`) run the plain path on every platform.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .. import platform
from ..quant.core import QuantizedTensor, dequantize
from .int4_matmul import int4_kernel_call, kernel_blocks, kernel_takes

__all__ = ["grouped_int4_matmul", "grouped_int4_matmul_plain"]


def grouped_int4_matmul_plain(x_sorted, tile_group_ids, qt, tile_m, compute_dtype):
    """The plain version: dequantize the stacked weights, then
    ``jax.lax.ragged_dot`` over the tile-aligned groups (float32 out)."""
    sizes = jnp.bincount(tile_group_ids, length=qt.shape[0]) * tile_m
    return jax.lax.ragged_dot(
        x_sorted.astype(compute_dtype),
        jnp.swapaxes(dequantize(qt, dtype=compute_dtype), 1, 2),
        sizes.astype(jnp.int32),
        precision=(jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
                   else jax.lax.Precision.DEFAULT),
        preferred_element_type=jnp.float32,
    )


def grouped_int4_matmul(
    x_sorted: jnp.ndarray,
    tile_group_ids: jnp.ndarray,
    qt: QuantizedTensor,
    *,
    tile_m: int = 16,
    compute_dtype=None,
    out_dtype=None,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Grouped ``x @ dequant(W[g])^T`` over tile-aligned token groups.

    Args:
      x_sorted: [T_pad, K] tokens sorted by expert; each expert's group is
        padded with zero rows to a multiple of ``tile_m`` (T_pad static).
      tile_group_ids: [T_pad // tile_m] i32 — expert id of each m-tile, in
        non-decreasing order.
      qt: stacked per-expert weights [E, N, K], per_row or per_group.
      interpret: run the Pallas kernel in the interpreter (tests).
    Returns [T_pad, N].
    """
    if len(qt.shape) != 3:
        raise ValueError(f"expected stacked [E, N, K] weights, got {qt.shape}")
    _, n, k = qt.shape
    t_pad = x_sorted.shape[0]
    if x_sorted.shape[1] != k:
        raise ValueError(f"x K={x_sorted.shape[1]} != weight K={k}")
    if t_pad % tile_m != 0:
        raise ValueError(f"T_pad={t_pad} not a multiple of tile_m={tile_m}")
    if compute_dtype is None:
        compute_dtype = (
            jnp.float32 if x_sorted.dtype == jnp.float32 else jnp.bfloat16
        )
    if out_dtype is None:
        out_dtype = x_sorted.dtype
    gids = tile_group_ids.astype(jnp.int32)

    mode = platform.kernel_mode(interpret)
    if mode == "plain" or not kernel_takes(qt):
        return grouped_int4_matmul_plain(
            x_sorted, gids, qt, tile_m, compute_dtype
        ).astype(out_dtype)
    if mode == "compiled" and (tile_m < 16 or tile_m & (tile_m - 1)):
        raise ValueError(
            f"tile_m={tile_m}: the compiled kernel takes m-tiles of a power "
            "of two >= 16 rows (the smallest tensor-core dot)"
        )
    gs = qt.group_size if qt.granularity == "per_group" else 0
    return int4_kernel_call(
        x_sorted, gids, qt, block_m=tile_m, compute_dtype=compute_dtype,
        out_dtype=out_dtype, interpret=mode == "interpret",
        **kernel_blocks(tile_m, n, k // 2, gs, grouped=True),
    )
