"""fused4bit — INT4 weight-only inference framework in JAX.

A from-scratch JAX/Pallas re-design with the capabilities of the reference
CUDA library `Fused-4-bit-Dequantize-Linear-CUDA-Kernel` (see SURVEY.md):

* quantization core with the reference's affine INT4 spec and a planar
  packing (``fused4bit.quant``)
* fused dequantize-matmul Pallas kernel (Triton route, NVIDIA GPUs) +
  drop-in ``QuantizedLinear``
  (``fused4bit.ops.int4_matmul``, ``fused4bit.layers.linear``)
* correct ragged grouped INT4 GEMM + MoE routing/dispatch/combine
  (``fused4bit.ops.grouped_matmul``, ``fused4bit.layers.moe``)
* INT4 KV cache, Mixtral-style decoder, continuous-batching engine
  (``fused4bit.layers.kv_cache``, ``models``, ``serving``)
* tensor/expert/pipeline/sequence parallelism over device meshes
  (``fused4bit.parallel``) + elastic checkpoint/resume
  (``fused4bit.utils.elastic``)
* benchmark + roofline harness (``fused4bit.utils``, ``benchmark/``)
* native host-side packer (``fused4bit.native``, ``csrc/``)
"""

from .quant import (  # noqa: F401
    QuantizedTensor,
    dequantize,
    dequantize_weights,
    quantize,
    quantize_weights,
    reference_linear_qt,
    reference_quantized_linear,
)
from .ops.int4_matmul import int4_matmul, quantized_linear  # noqa: F401
from .ops.decode_attention import int4_decode_attention  # noqa: F401
from .ops.grouped_matmul import grouped_int4_matmul  # noqa: F401
from .layers.linear import QuantizedLinear  # noqa: F401
from .layers.moe import (  # noqa: F401
    MoEINT4,
    QuantizedMoE,
    combine,
    dispatch,
    make_dispatch_plan,
    simulate_router_logits,
    topk_route,
)
from .layers.kv_cache import QuantizedKVCache  # noqa: F401
from .layers.paged_kv import PagedKVCache  # noqa: F401
from .ops.int8_xla import (  # noqa: F401
    int4_grouped_transient,
    int4_linear_transient,
)

__version__ = "0.1.0"

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "quantize_weights",
    "dequantize_weights",
    "reference_quantized_linear",
    "reference_linear_qt",
    "int4_matmul",
    "int4_decode_attention",
    "quantized_linear",
    "grouped_int4_matmul",
    "QuantizedLinear",
    "MoEINT4",
    "QuantizedMoE",
    "topk_route",
    "simulate_router_logits",
    "dispatch",
    "combine",
    "make_dispatch_plan",
    "QuantizedKVCache",
    "PagedKVCache",
    "int4_linear_transient",
    "int4_grouped_transient",
]
