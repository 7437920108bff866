"""The one place that decides how the program runs (`fused4bit.platform`),
the compile-cache rule, and `chip_smoke.py` refusing to run without a GPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from fused4bit import platform

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "name,interpret,mode",
    [
        ("gpu", None, "compiled"),
        ("gpu", False, "compiled"),
        ("gpu", True, "interpret"),
        ("cpu", None, "plain"),
        ("cpu", False, "plain"),
        ("cpu", True, "interpret"),
    ],
)
def test_kernel_mode(monkeypatch, name, interpret, mode):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert platform.backend() == name
    assert platform.kernel_mode(interpret) == mode


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_other_platforms_are_refused(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.kernel_mode()


def test_ragged_all_to_all_only_native_on_gpu(monkeypatch):
    assert platform.native_ragged_all_to_all() is False   # this CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.native_ragged_all_to_all() is True


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert platform.compile_cache_dir() == str(ROOT / ".jax_cache")


def test_enable_compile_cache_never_overrides_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert platform.enable_compile_cache() == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))]


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
