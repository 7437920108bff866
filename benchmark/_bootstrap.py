"""Make the repo root importable when running benchmark scripts directly,
and point JAX's persistent compile cache where `fused4bit.platform` says."""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from fused4bit import platform  # noqa: E402

platform.enable_compile_cache()
