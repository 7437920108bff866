"""Sharding rules for quantized pytrees (tensor parallelism).

JAX-native replacement for what the reference doesn't have (SURVEY.md §2.5):
tensor-parallel sharding of `QuantizedLinear` weights over a mesh `model`
axis, expert sharding of stacked MoE weights over an `expert` axis. The
scale/zero-point vectors shard with the dimension they describe (per-row
metadata follows the N dim; per-expert metadata follows the E dim).
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..quant.core import QuantizedTensor

__all__ = [
    "shard_qt_out_dim",
    "shard_qt_experts",
    "replicate",
    "qt_pspec_out_dim",
    "qt_pspec_experts",
]


def qt_pspec_out_dim(axis: str = "model") -> QuantizedTensor:
    """PartitionSpecs for a [N, K] QuantizedTensor column-parallel over N.

    packed [N, K/2] -> P(axis, None); scales/zps [N] -> P(axis).
    (per_group scales [N, G] -> P(axis, None).)
    """
    return dict(
        packed=P(axis, None),
        scales=P(axis),
        zero_points=P(axis),
    )


def qt_pspec_experts(axis: str = "expert") -> dict:
    """PartitionSpecs for stacked [E, N, K] expert weights sharded over E."""
    return dict(
        packed=P(axis, None, None),
        scales=P(axis, None),
        zero_points=P(axis, None),
    )


def _place(qt: QuantizedTensor, mesh: Mesh, specs: dict) -> QuantizedTensor:
    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    return QuantizedTensor(
        packed=put(qt.packed, specs["packed"]),
        scales=put(qt.scales, specs["scales"]),
        zero_points=put(qt.zero_points, specs["zero_points"]),
        shape=qt.shape,
        granularity=qt.granularity,
        layout=qt.layout,
        block_k=qt.block_k,
        group_size=qt.group_size,
        bits=qt.bits,
    )


def shard_qt_out_dim(qt: QuantizedTensor, mesh: Mesh, axis: str = "model"):
    """Column-parallel placement: output rows split over `axis`.

    The matmul then produces `axis`-sharded activations; XLA inserts the
    all-gather (or keeps them sharded into the next row-parallel layer).
    """
    if qt.granularity == "per_group":
        specs = dict(packed=P(axis, None), scales=P(axis, None), zero_points=P(axis, None))
    else:
        specs = qt_pspec_out_dim(axis)
    return _place(qt, mesh, specs)


def shard_qt_experts(qt: QuantizedTensor, mesh: Mesh, axis: str = "expert"):
    """Expert-parallel placement of stacked [E, N, K] weights."""
    return _place(qt, mesh, qt_pspec_experts(axis))


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree across the mesh."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), tree
    )
