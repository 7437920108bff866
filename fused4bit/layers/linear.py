"""QuantizedLinear — drop-in INT4 linear layer (pytree module).

Counterpart of the reference's ``QuantizedLinear(nn.Module)``
(`python/module.py:33-138`). Instead of ``register_buffer``
state on an ``nn.Module``, the layer is a frozen pytree dataclass holding a
:class:`~fused4bit.quant.QuantizedTensor` — it jits, vmaps, shards with
``jax.sharding``, and checkpoints with orbax out of the box.

Dispatch mirrors the reference (`python/module.py:113-118`): the fused INT4
matmul (`ops.int4_matmul`, which itself picks the compiled kernel on a GPU and
the plain path on the CPU), or the dequantize-then-matmul reference when the
caller asks for it with ``use_kernel=False``. ``from_dense`` is the ``from_linear`` converter
(`python/module.py:67-98`); unlike the reference (assert at :84) we support an
optional bias — it simply adds after the matmul and stays unquantized.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.int4_matmul import int4_matmul
from ..quant.core import QuantizedTensor, quantize
from ..quant.reference import reference_linear_qt

__all__ = ["QuantizedLinear", "DenseLinear"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseLinear:
    """Unquantized linear (bf16/f32) — for layers excluded from INT4 by a
    mixed-precision policy (routers, optionally lm_head). MoE routers are
    tiny ([E, H]) but their argmax decides expert assignment; quantizing
    them flips top-k choices on trained weights (see
    benchmark/results/quality_trained.json for the measured effect).
    """

    weight: jnp.ndarray  # [N, K]
    bias: Optional[jnp.ndarray] = None

    @property
    def in_dim(self) -> int:
        return self.weight.shape[1]

    @property
    def out_dim(self) -> int:
        return self.weight.shape[0]

    @property
    def nbytes(self) -> int:
        extra = (
            self.bias.size * self.bias.dtype.itemsize
            if self.bias is not None else 0
        )
        return self.weight.size * self.weight.dtype.itemsize + extra

    def as_xla_turbo(self) -> "DenseLinear":
        return self  # already XLA-native

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        y = x @ self.weight.T.astype(x.dtype)
        if self.bias is not None:
            y = y + self.bias.astype(y.dtype)
        return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """INT4 weight-only linear layer: ``y = x @ dequant(W)^T (+ b)``."""

    weight: QuantizedTensor
    bias: Optional[jnp.ndarray] = None
    use_kernel: bool = dataclasses.field(metadata=dict(static=True), default=True)
    activation: str = dataclasses.field(metadata=dict(static=True), default="bf16")
    # Optional int8-resident copy of the same int4 weights for the XLA-turbo
    # execution mode (activation="int8_xla"): 2x packed size, streamed by
    # XLA's matmul emitter — see ops/int8_xla.py for when this wins.
    w8: Optional[object] = None
    # Logical output dim when `weight` rows are padded to the kernel's best
    # tile multiple (quant.core.pad_rows); outputs are sliced back to it.
    out_features: Optional[int] = dataclasses.field(
        metadata=dict(static=True), default=None
    )

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dense(
        cls,
        weight: jnp.ndarray,
        bias: Optional[jnp.ndarray] = None,
        *,
        granularity: str = "per_row",
        use_kernel: bool = True,
        **quant_kw,
    ) -> "QuantizedLinear":
        """Quantize a dense [N, K] weight (reference from_linear,
        `python/module.py:67-98`).

        per_group weights pack group-major (layout="planar_groups") when
        128 | group_size | K/2; the kernel reads either layout."""
        layout = "planar"
        if granularity == "per_group":
            gs = quant_kw.get("group_size", 128)
            k_half = weight.shape[-1] // 2
            if gs % 128 == 0 and k_half % gs == 0:
                layout = "planar_groups"
        qt = quantize(weight, granularity=granularity, layout=layout, **quant_kw)
        return cls(weight=qt, bias=bias, use_kernel=use_kernel)

    @classmethod
    def init(
        cls,
        key: jax.Array,
        in_dim: int,
        out_dim: int,
        *,
        bias: bool = False,
        dtype=jnp.float32,
        **kw,
    ) -> "QuantizedLinear":
        w = jax.random.normal(key, (out_dim, in_dim), dtype) * (in_dim ** -0.5)
        b = jnp.zeros((out_dim,), dtype) if bias else None
        return cls.from_dense(w, b, **kw)

    # -- properties ----------------------------------------------------------

    @property
    def in_dim(self) -> int:
        return self.weight.in_dim

    @property
    def out_dim(self) -> int:
        return self.out_features or self.weight.out_dim

    @property
    def nbytes(self) -> int:
        extra = self.bias.size * self.bias.dtype.itemsize if self.bias is not None else 0
        return self.weight.nbytes + extra

    # -- forward -------------------------------------------------------------

    def as_xla_turbo(self) -> "QuantizedLinear":
        """Attach the i8-resident weight copy and switch to the XLA int8
        path. The packed u4 copy stays as the source of truth (checkpoints,
        metadata); serving memory is dominated by the i8 copy (~2x packed)."""
        from ..ops.int8_xla import to_int8_resident

        return dataclasses.replace(
            self, w8=to_int8_resident(self.weight), activation="int8_xla"
        )

    def as_u4_turbo(self) -> "QuantizedLinear":
        """Regime-dispatched execution with PACKED residency (no weight
        copies): decode-size inputs run the fused INT4 kernel; prefill-size
        inputs unpack to a per-call transient i8 tensor and run XLA's
        integer dot (`ops.int8_xla.int4_linear_transient`). The leading dim
        is static under jit, so the dispatch is compile-time."""
        return dataclasses.replace(self, activation="int8_auto")

    def padded_for_kernel(self) -> "QuantizedLinear":
        """Pre-pad weight rows to a multiple of 128, the kernel's widest
        n-block (`ops.int4_matmul.kernel_blocks`), once, so every n-block is
        full; outputs are sliced back to the logical ``out_features``."""
        from ..quant.core import pad_rows

        if self.weight.granularity not in ("per_row", "per_group"):
            return self
        padded = pad_rows(self.weight, 128)
        if padded is self.weight:
            return self
        return dataclasses.replace(
            self, weight=padded, out_features=self.weight.out_dim
        )

    # Leading-dim size at which the XLA transient path takes over from the
    # fused kernel under activation="int8_auto" (not yet measured on a GPU).
    _AUTO_PREFILL_M = 256

    def _matmul(self, x: jnp.ndarray) -> jnp.ndarray:
        w = self.weight
        activation = self.activation
        if activation == "int8_auto":
            m = 1
            for d in x.shape[:-1]:
                m *= d
            transient_ok = (
                w.layout == "planar" and w.granularity in ("per_row", "per_tensor")
            )
            if m >= self._AUTO_PREFILL_M and transient_ok:
                from ..ops.int8_xla import int4_linear_transient

                return int4_linear_transient(x, w)
        elif activation == "int8_xla" and self.w8 is not None:
            from ..ops.int8_xla import int8_linear

            return int8_linear(x, self.w8)
        if not self.use_kernel:
            return reference_linear_qt(x, w, dtype=x.dtype)
        return int4_matmul(x, w)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        y = self._matmul(x)
        if self.out_features and y.shape[-1] != self.out_features:
            y = y[..., : self.out_features]
        if self.bias is not None:
            y = y + self.bias.astype(y.dtype)
        return y

    def __repr__(self) -> str:  # reference extra_repr (`python/module.py:134-138`)
        return (
            f"QuantizedLinear(in={self.in_dim}, out={self.out_dim}, "
            f"bits={self.weight.bits}, granularity={self.weight.granularity}, "
            f"bias={self.bias is not None})"
        )
