"""Fused INT4 dequantize + matmul: a Pallas kernel for NVIDIA GPUs (Triton).

Re-design of the reference CUDA kernel `quantized_linear_optimized_kernel`
(`csrc/quantized_linear_kernel.cu:90-279`, SURVEY.md §3) for Hopper. The
reference reads the packed weights once as 16-byte vector loads, stages the
activations in shared memory, unpacks nibbles in registers and feeds an FMA
loop. Here:

* one program per (m-block, n-block, K split); the K loop runs inside the
  program (``lax.fori_loop``), so every weight byte is read once per
  m-block, and with several K splits XLA adds the float32 partials;
* the packed tile ``[BLOCK_N, BLOCK_KH]`` u8 is unpacked in registers: with
  the planar layout (:func:`fused4bit.quant.core.pack_planar`) the low
  nibble is column ``c`` and the high nibble, XOR 8, is column ``c + K/2``,
  so both halves are contiguous and each feeds its own ``pl.dot``;
* ``q - zp`` is an integer in ``[-15, 15]``, exact in bfloat16, so the dots
  run on the tensor cores in bf16 with float32 accumulation and the scale is
  applied to the [BLOCK_M, BLOCK_N] partial: once in the epilogue for
  per-row weights, once per K step (``BLOCK_KH`` divides the group) for
  per-group weights;
* a program reads its expert id from ``group_ids`` (one id per m-block), so
  the same kernel is the MoE grouped GEMM (`ops.grouped_matmul`); the linear
  layer is the one-expert case.

Choice of path (`fused4bit.platform`): the compiled kernel on a GPU at
decode sizes; the plain path (dequantize, then one ``dot_general`` left to
XLA) above ``prefill_threshold`` rows, on the CPU, and for weights the
kernel does not take; the Pallas interpreter only when a caller passes
``interpret=True``. On an H100 80GB HBM3 (700 W) the kernel beat the plain
path 2.4-4.1x at decode M=8 and 5.0-6.7x as the grouped MoE at T=8 and
T=2048 (device time, PERF.md).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import platform
from ..quant.core import QuantizedTensor, dequantize

__all__ = ["int4_matmul", "int4_matmul_plain", "kernel_takes", "quantized_linear"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap that divides n (Triton blocks are pow2)."""
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Kernel body (shared with ops.grouped_matmul)
# ---------------------------------------------------------------------------


def _int4_kernel(
    gid_ref,      # [num_m_blocks] i32 — expert of each m-block
    x_ref,        # [M, K]
    w_ref,        # planar [E, N, K/2] u8  |  planar_groups [E, Gh, N, gs] u8
    s_ref,        # per_row [E, N] f32  |  per_group [E, N, 2*Gh] f32
    z_ref,        # same shape as s_ref (integer-valued)
    o_ref,        # [k_splits, M, N]: one partial sum per K split
    *,
    m: int, n: int, k_half: int,
    block_m: int, block_n: int, block_kh: int, k_steps: int,
    group_size: int,       # 0 for per_row
    grouped_layout: bool,  # planar_groups bytes
    compute_dtype,
):
    i, j, split = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    e = gid_ref[i]
    rows = i * block_m + jnp.arange(block_m)
    cols = j * block_n + jnp.arange(block_n)
    row_ok = (rows < m)[:, None]
    col_ok = cols < n
    rsl = pl.ds(i * block_m, block_m)
    csl = pl.ds(j * block_n, block_n)
    cd = compute_dtype
    prec = (jax.lax.Precision.HIGHEST if cd == jnp.float32
            else jax.lax.Precision.DEFAULT)
    gh = k_half // group_size if group_size else 0

    def affine(g):
        """(scale, integer zero-point) columns for scale group g: [BN]."""
        if group_size:
            s = plgpu.load(s_ref.at[e, csl, g], mask=col_ok, other=0.0)
            z = plgpu.load(z_ref.at[e, csl, g], mask=col_ok, other=0.0)
        else:
            s = plgpu.load(s_ref.at[e, csl], mask=col_ok, other=0.0)
            z = plgpu.load(z_ref.at[e, csl], mask=col_ok, other=0.0)
        return s, z.astype(jnp.int32)

    def half_dot(xh, q, z):
        w = (q - z[:, None]).astype(cd)            # exact: |q - z| <= 15
        return pl.dot(xh.astype(cd), w, trans_b=True, precision=prec)

    if not group_size:
        s_row, z_row = affine(0)

    def body(kk, acc):
        k0 = (split * k_steps + kk) * block_kh
        x_lo = plgpu.load(x_ref.at[rsl, pl.ds(k0, block_kh)], mask=row_ok,
                          other=0.0)
        x_hi = plgpu.load(x_ref.at[rsl, pl.ds(k_half + k0, block_kh)],
                          mask=row_ok, other=0.0)
        if grouped_layout:
            g = k0 // group_size
            wsl = w_ref.at[e, g, csl, pl.ds(k0 - g * group_size, block_kh)]
        else:
            wsl = w_ref.at[e, csl, pl.ds(k0, block_kh)]
        p = plgpu.load(wsl, mask=col_ok[:, None], other=0).astype(jnp.int32)
        lo = p & 0x0F
        hi = (p >> 4) ^ 0x08
        if group_size:
            g = k0 // group_size
            s_lo, z_lo = affine(g)
            s_hi, z_hi = affine(gh + g)
            return (acc + half_dot(x_lo, lo, z_lo) * s_lo[None, :]
                    + half_dot(x_hi, hi, z_hi) * s_hi[None, :])
        return acc + half_dot(x_lo, lo, z_row) + half_dot(x_hi, hi, z_row)

    acc = jax.lax.fori_loop(
        0, k_steps, body, jnp.zeros((block_m, block_n), jnp.float32),
    )
    if not group_size:
        acc = acc * s_row[None, :]
    plgpu.store(o_ref.at[split, rsl, csl], acc.astype(o_ref.dtype),
                mask=row_ok & col_ok[None, :])


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_m", "block_n", "block_kh", "k_splits", "num_warps",
        "num_stages", "compute_dtype", "out_dtype", "interpret",
    ),
)
def int4_kernel_call(
    x, group_ids, qt: QuantizedTensor,
    *, block_m: int, block_n: int, block_kh: int, k_splits: int,
    num_warps: int, num_stages: int, compute_dtype, out_dtype,
    interpret: bool,
):
    """``out[r] = x[r] @ dequant(W[group_ids[r // block_m]])^T``.

    x: [M, K]; qt: stacked [E, N, K] per_row or per_group weights, planar or
    planar_groups; group_ids: [cdiv(M, block_m)] i32. Returns [M, N].
    With ``k_splits`` > 1 each program sums one K slice into a float32
    partial and XLA adds the partials (more programs for a skinny M)."""
    m, k = x.shape
    e, n, _ = qt.shape
    k_half = k // 2
    steps = k_half // block_kh
    if block_kh * steps != k_half or steps % k_splits:
        raise ValueError(
            f"block_kh={block_kh} x k_splits={k_splits} must tile K/2={k_half}")
    gs = qt.group_size if qt.granularity == "per_group" else 0
    kernel = functools.partial(
        _int4_kernel, m=m, n=n, k_half=k_half,
        block_m=block_m, block_n=block_n, block_kh=block_kh,
        k_steps=steps // k_splits,
        group_size=gs, grouped_layout=qt.layout == "planar_groups",
        compute_dtype=compute_dtype,
    )
    part_dtype = out_dtype if k_splits == 1 else jnp.float32
    out = pl.pallas_call(
        kernel,
        grid=(_cdiv(m, block_m), _cdiv(n, block_n), k_splits),
        out_shape=jax.ShapeDtypeStruct((k_splits, m, n), part_dtype),
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="int4_matmul",
    )(
        group_ids.astype(jnp.int32), x, qt.packed,
        qt.scales.astype(jnp.float32), qt.zero_points.astype(jnp.float32),
    )
    return out[0] if k_splits == 1 else out.sum(axis=0).astype(out_dtype)


def kernel_blocks(block_m: int, n: int, k_half: int, group_size: int,
                  *, grouped: bool = False) -> dict:
    """Block sizes and launch parameters of the kernel for m-blocks of
    ``block_m`` rows, N outputs and K/2 packed bytes per row.

    The blocks, and so the order in which a row's products are summed, never
    depend on how many m-blocks a launch has: a row's result must not change
    with the other rows of the batch, or with how many of a layer's experts
    one card holds (the DP x EP mesh gives the one-card engine's tokens).
    They are tuned for the one-card engine's launches: one m-block for a
    linear (decode up to 16 rows, prefill chunks of 64), nine for the
    grouped MoE (one per Mixtral expert, plus the spare tile).

    Chosen on an H100 80GB HBM3 with `benchmark/tune_kernel_blocks.py` at
    the Mixtral-8x7B widths (decode M=8 linears, grouped T=8 and T=2048,
    linears at M=64 and 512). Decode-size m-blocks are bound by weight
    bytes: 64-wide n-blocks, 128-byte K steps, and the K range split until
    there are about eight programs per SM. Larger m-blocks are bound by the
    tensor cores: 128-wide n-blocks with 32-byte K steps, or 64 and 64 when
    there are few n-blocks; both halves' x tiles must fit shared memory."""
    m_blocks = 9 if grouped else 1
    steps_of = lambda cap: _pow2_divisor(group_size or k_half, cap)  # noqa: E731
    if block_m > 16:
        wide = m_blocks * _cdiv(n, 128) >= 2 * 132
        return dict(block_n=128 if wide else 64,
                    block_kh=steps_of(min(group_size or 128, 32 if wide else 64)),
                    k_splits=1, num_warps=4, num_stages=3)
    block_kh = steps_of(min(group_size or 128, 128))
    programs = m_blocks * _cdiv(n, 64)
    steps = k_half // block_kh
    k_splits = 1
    while (programs * k_splits < 8 * 132 and k_splits < 8
           and steps % (2 * k_splits) == 0):
        k_splits *= 2
    return dict(block_n=64, block_kh=block_kh, k_splits=k_splits,
                num_warps=4, num_stages=4)


# ---------------------------------------------------------------------------
# Plain path
# ---------------------------------------------------------------------------


def int4_matmul_plain(x, qt: QuantizedTensor, *, compute_dtype=None, out_dtype=None):
    """The plain version: dequantize the weight in ``compute_dtype``, then
    one ``dot_general`` left to XLA (float32 accumulation)."""
    compute_dtype, out_dtype = _dtypes(x, compute_dtype, out_dtype)
    prec = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    return jax.lax.dot_general(
        x.astype(compute_dtype), dequantize(qt, dtype=compute_dtype),
        (((x.ndim - 1,), (1,)), ((), ())), precision=prec,
        preferred_element_type=jnp.float32,
    ).astype(out_dtype)


def kernel_takes(qt: QuantizedTensor) -> bool:
    """Whether the kernel reads this weight: planar or planar_groups bytes,
    per_row or per_group scales, and whole scale groups in each planar half
    (a K step must not straddle the halves). Other weights take the plain
    path on every platform."""
    if qt.layout not in ("planar", "planar_groups"):
        return False
    if qt.granularity == "per_row":
        return True
    return qt.granularity == "per_group" and (qt.in_dim // 2) % qt.group_size == 0


def _dtypes(x, compute_dtype, out_dtype):
    if compute_dtype is None:
        compute_dtype = jnp.float32 if x.dtype == jnp.float32 else jnp.bfloat16
    return compute_dtype, out_dtype or x.dtype


# ---------------------------------------------------------------------------
# Public wrapper
# ---------------------------------------------------------------------------


def int4_matmul(
    x: jnp.ndarray,
    qt: QuantizedTensor,
    *,
    compute_dtype=None,
    out_dtype=None,
    interpret: Optional[bool] = None,
    prefill_threshold: int = 512,
) -> jnp.ndarray:
    """``x @ dequant(qt)^T`` without materializing the dense weight.

    Args:
      x:  [..., K] activations (f32 or bf16).
      qt: weight [N, K]. The kernel takes planar/planar_groups bytes with
        per_row or per_group scales (`kernel_takes`); any other weight runs
        the plain path.
      interpret: run the Pallas kernel in the interpreter (tests).
      prefill_threshold: above this many rows the product is bound by the
        tensor cores, not by weight bytes, so the plain path (dequantize
        once, XLA's GEMM) runs on every platform.
    Returns [..., N].
    """
    if len(qt.shape) != 2:
        raise ValueError(f"expected a [N, K] weight, got {qt.shape}")
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    gs = qt.group_size if qt.granularity == "per_group" else 0
    compute_dtype, out_dtype = _dtypes(x, compute_dtype, out_dtype)

    lead = x.shape[:-1]
    m = math.prod(lead)
    mode = platform.kernel_mode(interpret)
    if mode == "plain" or m > prefill_threshold or not kernel_takes(qt):
        return int4_matmul_plain(
            x, qt, compute_dtype=compute_dtype, out_dtype=out_dtype
        )

    block_m = 16 if m <= 16 else 64
    blocks = kernel_blocks(block_m, n, k // 2, gs)
    stacked = dataclasses.replace(
        qt, packed=qt.packed[None], scales=qt.scales[None],
        zero_points=qt.zero_points[None], shape=(1,) + tuple(qt.shape),
    )
    out = int4_kernel_call(
        x.reshape(m, k), jnp.zeros((_cdiv(m, block_m),), jnp.int32), stacked,
        block_m=block_m, compute_dtype=compute_dtype, out_dtype=out_dtype,
        interpret=mode == "interpret", **blocks,
    )
    return out.reshape(*lead, n)


def quantized_linear(x, qt: QuantizedTensor, **kw):
    """Alias with the reference's forward semantics (`python/module.py:100`)."""
    return int4_matmul(x, qt, **kw)
