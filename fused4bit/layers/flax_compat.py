"""Flax linen wrappers — drop-in modules for flax codebases.

The reference's `QuantizedLinear` is a drop-in `nn.Linear` replacement for
torch models (`python/module.py:21-33`); this is the same
courtesy for the JAX ecosystem's dominant module system. The packed weights
live as non-trainable linen *variables* (collection ``"quantized"``), so
`model.init` / `.apply` / checkpointing work the standard flax way while the
compute path is the fused Pallas kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

try:
    import flax.linen as nn

    _FLAX = True
except Exception:  # pragma: no cover
    _FLAX = False

from ..ops.int4_matmul import int4_matmul
from ..quant.core import quantize

__all__ = ["QuantizedDense"]


if _FLAX:

    class QuantizedDense(nn.Module):
        """linen ``nn.Dense`` replacement with INT4 packed weights.

        Initialized from a dense kernel init (quantized at init time), or
        populate the ``quantized`` collection from a converted checkpoint.
        Note the weight convention: flax Dense keeps [K, N]; we store the
        reference's [N, K].
        """

        features: int
        use_bias: bool = False
        kernel_init: nn.initializers.Initializer = nn.initializers.lecun_normal()
        bias_init: nn.initializers.Initializer = nn.initializers.zeros_init()

        @nn.compact
        def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
            k = x.shape[-1]

            def init_packed(key):
                w = self.kernel_init(key, (k, self.features), jnp.float32)
                qt = quantize(w.T, granularity="per_row", layout="planar")
                return qt

            qt = self.variable(
                "quantized", "weight", init_packed, self.make_rng("params")
                if self.has_rng("params") else jax.random.PRNGKey(0),
            ).value
            y = int4_matmul(x, qt)
            if self.use_bias:
                b = self.param("bias", self.bias_init, (self.features,), jnp.float32)
                y = y + b.astype(y.dtype)
            return y

else:  # pragma: no cover

    class QuantizedDense:  # type: ignore
        def __init__(self, *a, **k):
            raise ImportError("flax is not available")
