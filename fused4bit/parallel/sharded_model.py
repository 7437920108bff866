"""Whole-model sharded decode: DP batch x EP experts under one shard_map.

Glues the parallel layer into `QuantizedTransformer`: attention / norms /
embeddings replicate, each MoE block's stacked expert weights shard over the
mesh `expert` axis, the batch (tokens + KV caches) shards over `data`. Inside
the shard_map, attention runs locally on the batch shard and every MoE block
uses the dropless EP strategy (local grouped INT4 GEMM on the device's
experts + psum combine over the expert axis — see
`fused4bit.parallel.expert_parallel.moe_ep_replicated` for the rationale:
in the decode regime the 1/D split of weight streaming is the win, and no
token is ever dropped).

This is the multi-card serving configuration: Mixtral-geometry INT4 decode,
experts sharded across the cards.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..layers.moe import (
    RoutingResult,
    combine,
    dispatch,
    make_dispatch_plan,
    topk_route,
)
from ..models.transformer import MoEBlock, QuantizedTransformer, rms_norm
from ..quant.core import QuantizedTensor

__all__ = ["model_pspecs", "place_model", "sharded_decode_step"]

_EXPERT_FIELDS = ("w_gate", "w_up", "w_down")


def model_pspecs(model: QuantizedTransformer, expert_axis: str = "expert"):
    """PartitionSpec pytree for the model: expert weights sharded, rest
    replicated."""

    def spec_for(path, leaf):
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if any(k in _EXPERT_FIELDS for k in keys if k):
            if leaf.ndim == 3:      # packed [E, N, K/2]
                return P(expert_axis, None, None)
            if leaf.ndim == 2:      # scales/zps [E, N]
                return P(expert_axis, None)
        return P()

    return jax.tree_util.tree_map_with_path(spec_for, model)


def place_model(model: QuantizedTransformer, mesh: Mesh, expert_axis="expert"):
    """Device-put the model with expert sharding over the mesh."""
    specs = model_pspecs(model, expert_axis)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), model, specs
    )


def _ep_moe_block(block: MoEBlock, x: jnp.ndarray, axis: str, interpret):
    """MoEBlock forward on a local expert shard + psum combine.

    ``block`` holds LOCAL shards (w_* stacked over E_local); the router is
    replicated and produces global logits. Mirrors MoEBlock.__call__
    (models/transformer.py) with the expert-parallel filter of
    expert_parallel.moe_ep_replicated.
    """
    b, t, h = x.shape
    xf = x.reshape(b * t, h)
    # NOTE: QuantizedTensor.shape is static metadata and still reports the
    # *global* E inside shard_map — the local shard size comes from the
    # actual packed leaf.
    e_local = block.w_gate.weight.packed.shape[0]
    n_dev = jax.lax.axis_size(axis)
    e_global = block.num_experts
    assert e_local * n_dev == e_global, (e_local, n_dev, e_global)
    dev = jax.lax.axis_index(axis)
    lo = dev * e_local

    import dataclasses as _dc

    def _local(m):
        qt = m.weight
        return _dc.replace(
            m,
            weight=QuantizedTensor(
                packed=qt.packed, scales=qt.scales, zero_points=qt.zero_points,
                shape=(e_local,) + qt.shape[1:],
                granularity=qt.granularity, layout=qt.layout,
                block_k=qt.block_k, group_size=qt.group_size, bits=qt.bits,
            ),
        )

    w_gate, w_up, w_down = _local(block.w_gate), _local(block.w_up), _local(block.w_down)

    routing = topk_route(block.router(xf), block.top_k, e_global)
    local_ids = routing.expert_indices - lo
    mine = (local_ids >= 0) & (local_ids < e_local)
    local_ids = jnp.where(mine, local_ids, 0).astype(jnp.int32)
    weights = jnp.where(mine, routing.expert_weights, 0.0)
    tpe = jnp.bincount(local_ids.reshape(-1), length=e_local).astype(jnp.int32)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(tpe)]
    ).astype(jnp.int32)
    local_routing = RoutingResult(local_ids, weights, tpe, offsets)

    # MoEBlock's m-tile for this many tokens, so each token's expert rows run
    # in the blocks they run in on one card
    tile_m = block.prefill_tile_m if b * t > block.prefill_threshold else block.tile_m
    plan = make_dispatch_plan(local_routing, e_local, tile_m=tile_m)
    xs = dispatch(xf, local_routing, plan)
    g = w_gate(xs, plan.tile_group_ids, tile_m=tile_m, interpret=interpret)
    u = w_up(xs, plan.tile_group_ids, tile_m=tile_m, interpret=interpret)
    hsw = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)).astype(xs.dtype)
    d = w_down(hsw, plan.tile_group_ids, tile_m=tile_m, interpret=interpret)
    part = combine(d, local_routing, plan)
    out = jax.lax.psum(part, axis)
    return out.reshape(b, t, h)


def sharded_decode_step(
    model: QuantizedTransformer,
    mesh: Mesh,
    tokens: jnp.ndarray,      # [B, T] i32, B divisible by data-axis size
    caches: Tuple,            # per-layer QuantizedKVCache, batch-sharded
    positions: jnp.ndarray,   # [B, T] i32
    *,
    data_axis: str = "data",
    expert_axis: str = "expert",
    interpret=None,
):
    """One forward step of the fully sharded model. Returns (logits, caches)."""
    mspecs = model_pspecs(model, expert_axis)
    dspec = P(data_axis, None)
    cache_spec = jax.tree.map(
        lambda a: P(data_axis, *([None] * (a.ndim - 1))), caches
    )

    def body(model, tokens, caches, positions):
        x = model.embed[tokens]
        new_caches = []
        for blk, cache in zip(model.blocks, caches):
            h, cache = blk.attn(
                rms_norm(x, blk.attn_norm, blk.rms_eps), cache, positions
            )
            x = x + h
            x = x + _ep_moe_block(
                blk.moe, rms_norm(x, blk.moe_norm, blk.rms_eps),
                expert_axis, interpret,
            )
            new_caches.append(cache)
        x = rms_norm(x, model.final_norm, model.rms_eps)
        logits = model.lm_head(x)
        return logits, tuple(new_caches)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(mspecs, dspec, cache_spec, dspec),
        out_specs=(dspec, cache_spec),
        check_vma=False,
    )
    return fn(model, tokens, caches, positions)
