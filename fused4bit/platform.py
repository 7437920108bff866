"""The one place that decides how this program runs on the device it finds.

* ``"gpu"`` gets the compiled Pallas kernels (Triton route).
* ``"cpu"`` gets the plain JAX path, or the Pallas interpreter when a caller
  asks for it with ``interpret=True`` (the tests do).
* Any other platform is refused: no path falls back quietly.

It also fixes where JAX keeps its persistent compile cache.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

import jax

__all__ = [
    "backend", "kernel_mode", "native_ragged_all_to_all",
    "compile_cache_dir", "enable_compile_cache",
]

_SUPPORTED = ("gpu", "cpu")

# Fixed in-checkout cache path, used only when JAX_COMPILATION_CACHE_DIR is
# unset. A fixed path matters: the path is part of the cache key.
_DEFAULT_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def backend() -> str:
    """``"gpu"`` or ``"cpu"``; raises on any other platform."""
    name = jax.default_backend()
    if name not in _SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this program runs on an "
            "NVIDIA GPU (compiled kernels) or the CPU (plain path, tests)"
        )
    return name


def kernel_mode(interpret: Optional[bool] = None) -> str:
    """How a kernel wrapper should run: ``"compiled"``, ``"interpret"`` or
    ``"plain"``.

    ``interpret=True`` always runs the Pallas kernel in the interpreter.
    Otherwise the platform decides: the compiled kernel on a GPU, the plain
    JAX path on the CPU.
    """
    if interpret:
        return "interpret"
    return "compiled" if backend() == "gpu" else "plain"


def native_ragged_all_to_all() -> bool:
    """Whether ``jax.lax.ragged_all_to_all`` lowers here: on the GPU it does
    (NCCL), XLA:CPU has no such collective and takes the emulation."""
    return backend() == "gpu"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_DEFAULT_CACHE)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    When the environment variable is set JAX already reads it, so nothing
    is overridden. Returns the directory in use."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
