"""Device-mesh helpers.

The reference has no distributed support at all (SURVEY.md §2.5 absence
inventory — no torch.distributed, no NCCL, single GPU). Here the scale-out
story is JAX-native: named meshes + shard_map, XLA collectives over NVLink/DCN.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "best_mesh_shape"]


def best_mesh_shape(n: int, num_axes: int = 2) -> Tuple[int, ...]:
    """Factor n devices into a near-square mesh shape (largest factors last)."""
    if num_axes == 1:
        return (n,)
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    if num_axes == 2:
        return (a, n // a)
    rest = best_mesh_shape(n // a, num_axes - 1)
    return (a, *rest)


def make_mesh(
    axis_names: Sequence[str] = ("data", "expert", "model"),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Build a named mesh over available devices.

    Default axes: ('data', 'expert', 'model') — DP batches over `data`,
    experts shard over `expert` (all_to_all rides NVLink), TP shards over
    `model`. With no `shape`, all devices go to `expert` (the highest-value
    axis for INT4 MoE decode) and the other axes are 1.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = [1] * len(axis_names)
        shape[axis_names.index("expert") if "expert" in axis_names else 0] = n
    shape = tuple(shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))
