"""Checkpoint save/restore for quantized pytrees (Orbax).

The reference persists quantized weights only implicitly through
``register_buffer`` -> ``state_dict()`` (`python/module.py:
54-64`, `python/moe_int4_module.py:96-105`). JAX equivalent per SURVEY.md §5:
Orbax over the quantized pytree — every module here (QuantizedTensor,
QuantizedLinear, MoEINT4, QuantizedTransformer, KV caches) is a registered
dataclass pytree, so checkpoints are one call each way. Static metadata
(shapes, layout, granularity) rides in the pytree structure, so ``load``
takes a template with the right structure (the usual Orbax pattern).
"""
from __future__ import annotations

import os
from typing import Any

import jax

__all__ = ["save", "load"]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def save(path: str, tree: Any) -> None:
    """Write a pytree checkpoint to `path` (a directory)."""
    path = os.path.abspath(os.path.expanduser(path))
    ckpt = _checkpointer()
    ckpt.save(path, tree)
    ckpt.wait_until_finished()


def load(path: str, template: Any, shardings: Any = None) -> Any:
    """Restore a pytree checkpoint saved by :func:`save`.

    `template` supplies the pytree structure + static metadata (e.g. a model
    built with the same config; array values are ignored).

    `shardings`: optional pytree of `jax.sharding.Sharding` matching
    `template`'s structure — each restored array is materialized directly
    with that sharding (the multi-chip restore path: save under one mesh,
    restore under another, including a different data-parallel size; Orbax
    reshards from the checkpoint layout).
    """
    path = os.path.abspath(os.path.expanduser(path))
    ckpt = _checkpointer()
    if shardings is None:
        abstract = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
            if hasattr(a, "shape")
            else a,
            template,
        )
    else:
        abstract = jax.tree.map(
            lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=s)
            if hasattr(a, "shape")
            else a,
            template, shardings,
        )
    return ckpt.restore(path, abstract)
