"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding tests need more than one device, so the CPU backend is
split into 8 virtual devices. Kernel tests pass ``interpret=True`` and run
the Pallas kernels in the interpreter; everything else takes the plain path
the CPU gets (`fused4bit.platform`).

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere, through the
``gpu`` fixture. The suite defaults to the CPU; on a machine with the card
the marked tests run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os

# Must run before jax initializes a backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]
