"""Multi-host initialization + helpers.

SURVEY.md §2.5: the JAX equivalent of distributed process-group setup is
standard JAX distributed init — no hand-written backend. This module is the
framework's entry point for multi-host runs: call :func:`initialize` once
per process before touching devices, then every mesh/shard_map path in
`fused4bit.parallel` works unchanged (meshes built from `jax.devices()` span
all hosts' devices; XLA hands collectives to NCCL).

Single-process runs (including the virtual CPU meshes used in tests) need no
initialization — :func:`initialize` is a no-op when no coordinator is
configured.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize", "is_multihost", "local_device_slice"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize JAX distributed (idempotent, env-var aware).

    Arguments default to the standard env vars (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID). Nothing is inferred: without a coordinator
    this is a single-process run.
    Returns True if distributed mode is active.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or _env_int("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("PROCESS_ID")

    if coordinator_address is None and num_processes is None:
        # single process: nothing to initialize
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError:
        # already initialized
        return jax.process_count() > 1


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_device_slice(mesh_axis_size: int) -> slice:
    """Index range of this process's devices within a flat device list."""
    per = jax.local_device_count()
    start = jax.process_index() * per
    return slice(start, start + per)
