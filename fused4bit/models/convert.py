"""Dense checkpoint -> INT4 model conversion.

The offline entry point of the reference is `QuantizedLinear.from_linear`
(`python/module.py:67-98`): take trained full-precision
weights, quantize, pack. This module is that pipeline for a whole
Mixtral-family decoder: a flat dict of dense arrays (the layout you get from
`safetensors`/HF `state_dict`-style exports) becomes a `QuantizedTransformer`
with every projection per-row INT4 planar-packed.

The heavy per-row quantize+pack runs through the native C++ packer
(`fused4bit.native`, OpenMP) when available — the reference's own MoE
packer is a Python loop (`python/moe_int4_module.py:62-76`); multi-GB
checkpoints need better.

Expected key schema (HF-Mixtral-like, `{L}` = layer index, `{E}` = expert):
  embed.weight                                  [V, H]
  layers.{L}.attn_norm.weight                   [H]
  layers.{L}.attn.{q,k,v,o}_proj.weight         [*, *]
  layers.{L}.moe_norm.weight                    [H]
  layers.{L}.moe.router.weight                  [E, H]
  layers.{L}.moe.experts.{E}.{w1,w2,w3}.weight  (w1=gate [F,H], w2=down [H,F], w3=up [F,H])
  final_norm.weight                             [H]
  lm_head.weight                                [V, H]
"""
from __future__ import annotations

from typing import Callable, Mapping

import jax.numpy as jnp
import numpy as np

from .. import native
from ..layers.linear import QuantizedLinear
from ..layers.moe import MoEINT4
from ..quant.core import QuantizedTensor
from .config import ModelConfig
from .transformer import Attention, MoEBlock, QuantizedTransformer, TransformerBlock

__all__ = ["quantize_dense_2d", "convert_checkpoint", "convert_safetensors"]


def quantize_dense_2d(w: np.ndarray) -> QuantizedTensor:
    """Per-row INT4 planar quantization of a dense [N, K] array via the
    native packer (NumPy fallback inside)."""
    w = np.asarray(w, np.float32)
    packed, scales, zps = native.quantize_pack_planar(w)
    return QuantizedTensor(
        packed=jnp.asarray(packed),
        scales=jnp.asarray(scales),
        zero_points=jnp.asarray(zps),
        shape=tuple(w.shape),
        granularity="per_row",
        layout="planar",
        block_k=w.shape[1],
    )


def _qlinear(w: np.ndarray) -> QuantizedLinear:
    return QuantizedLinear(weight=quantize_dense_2d(w))


def _stack_experts(get: Callable[[int], np.ndarray], num: int) -> QuantizedTensor:
    """Quantize each expert with the native packer and stack [E, N, K/2]."""
    packed, scales, zps = [], [], []
    shape = None
    for e in range(num):
        w = np.asarray(get(e), np.float32)
        shape = w.shape
        p, s, z = native.quantize_pack_planar(w)
        packed.append(p)
        scales.append(s)
        zps.append(z)
    return QuantizedTensor(
        packed=jnp.asarray(np.stack(packed)),
        scales=jnp.asarray(np.stack(scales)),
        zero_points=jnp.asarray(np.stack(zps)),
        shape=(num,) + tuple(shape),
        granularity="per_row",
        layout="planar",
        block_k=shape[1],
    )


def convert_safetensors(
    path: str, cfg: ModelConfig, dtype=jnp.bfloat16, **kw
) -> QuantizedTransformer:
    """Load a .safetensors checkpoint (native reader, models/safetensors_io)
    and quantize it into an INT4 model. Extra kwargs (granularity,
    awq_tokens, ...) pass through to :func:`convert_checkpoint`."""
    from .safetensors_io import load_safetensors

    return convert_checkpoint(load_safetensors(path), cfg, dtype=dtype, **kw)


def convert_checkpoint(
    params: Mapping[str, np.ndarray],
    cfg: ModelConfig,
    dtype=jnp.bfloat16,
    *,
    quantize_router: bool = False,
    quantize_lm_head: bool = True,
    granularity: str = "per_row",
    group_size: int = 128,
    awq_tokens=None,
    awq_alpha=None,
) -> QuantizedTransformer:
    """Build an INT4 `QuantizedTransformer` from a flat dense-weight dict.

    Mixed-precision policy: the MoE router defaults to DENSE (bf16) — it is
    [E, H]-tiny but its argmax decides expert assignment, and quantizing it
    measurably degrades trained-weight top-1 agreement; `quantize_lm_head`
    stays True by default (the [V, H] head is a real memory consumer).

    ``awq_tokens``: optional [B, T] calibration token ids — applies
    activation-aware equalization (quant/equalize.py) to the dense weights
    before quantization: per-channel scales folded into the RMSNorm
    weights, alpha grid-searched per site unless ``awq_alpha`` pins it.
    """
    from ..layers.linear import DenseLinear
    from ..quant.core import quantize as _jq

    if awq_tokens is not None:
        from ..quant.equalize import awq_equalize_params

        params = awq_equalize_params(
            params, cfg, awq_tokens,
            granularity=granularity, group_size=group_size, alpha=awq_alpha,
            quantize_lm_head=quantize_lm_head,
        )

    def _q(w):
        """Quantize one dense [N, K] weight at the requested granularity."""
        if granularity == "per_row":
            return _qlinear(w)
        qt = _jq(jnp.asarray(w, jnp.float32), granularity=granularity,
                 layout="planar", group_size=group_size)
        return QuantizedLinear(weight=qt)

    def _qstack(get, num):
        if granularity == "per_row":
            return _stack_experts(get, num)
        ws = jnp.stack([jnp.asarray(get(i), jnp.float32) for i in range(num)])
        return _jq(ws, granularity=granularity, layout="planar",
                   group_size=group_size)

    def _router(w):
        if quantize_router:
            return _qlinear(w)
        return DenseLinear(weight=jnp.asarray(w, dtype))

    hidden = cfg.num_heads * cfg.head_dim
    blocks = []
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        attn = Attention(
            wq=_q(params[f"{pre}.attn.q_proj.weight"]),
            wk=_q(params[f"{pre}.attn.k_proj.weight"]),
            wv=_q(params[f"{pre}.attn.v_proj.weight"]),
            wo=_q(params[f"{pre}.attn.o_proj.weight"]),
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta,
        )
        e = cfg.moe.num_experts
        moe = MoEBlock(
            router=_router(params[f"{pre}.moe.router.weight"]),
            w_gate=MoEINT4(weight=_qstack(
                lambda i: params[f"{pre}.moe.experts.{i}.w1.weight"], e)),
            w_up=MoEINT4(weight=_qstack(
                lambda i: params[f"{pre}.moe.experts.{i}.w3.weight"], e)),
            w_down=MoEINT4(weight=_qstack(
                lambda i: params[f"{pre}.moe.experts.{i}.w2.weight"], e)),
            num_experts=e,
            top_k=cfg.moe.top_k,
        )
        blocks.append(
            TransformerBlock(
                attn_norm=jnp.asarray(params[f"{pre}.attn_norm.weight"], dtype),
                attn=attn,
                moe_norm=jnp.asarray(params[f"{pre}.moe_norm.weight"], dtype),
                moe=moe,
                rms_eps=cfg.rms_eps,
            )
        )
    return QuantizedTransformer(
        embed=jnp.asarray(params["embed.weight"], dtype),
        blocks=tuple(blocks),
        final_norm=jnp.asarray(params["final_norm.weight"], dtype),
        lm_head=(_q(params["lm_head.weight"])
                 if quantize_lm_head
                 else DenseLinear(
                     weight=jnp.asarray(params["lm_head.weight"], dtype))),
        rms_eps=cfg.rms_eps,
    )
