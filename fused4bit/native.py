"""ctypes loader for the native host-side quantize/pack library.

Build-system role of the reference's `setup.py:22-48` (CUDAExtension build):
the device kernels are Pallas (no native build needed); the one genuinely
native host component is the offline weight converter
(`csrc/quantpack.cpp`). It is compiled on demand with g++ (cached .so) and
exposed through ctypes — no pybind11 dependency. Falls back to NumPy when no
compiler is available; `quantize_pack_planar` output is bit-identical either
way (validated in tests/test_native.py).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_available", "quantize_pack_planar", "dequantize_planar"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "quantpack.cpp")
_LIB_PATH = os.path.join(_HERE, "csrc", "_quantpack.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        _SRC, "-o", _LIB_PATH,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _LIB_PATH
    except Exception:
        # retry without openmp/march (portability)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _LIB_PATH],
                check=True, capture_output=True, timeout=120,
            )
            return _LIB_PATH
        except Exception:
            return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _LIB_PATH if os.path.exists(_LIB_PATH) else _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.quantize_pack_planar_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.dequantize_planar_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _numpy_quantize_pack(w: np.ndarray):
    """Pure-NumPy fallback, numerically identical to the C++ path."""
    n, k = w.shape
    mn = w.min(axis=1)
    mx = w.max(axis=1)
    scale = (mx - mn) / 15.0
    scale = np.where(mx == mn, np.maximum(np.abs(mx), 1.0) / 15.0, scale)
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    zp = np.clip(np.round(-mn / scale), 0, 15).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None] + zp[:, None]), 0, 15).astype(np.uint8)
    half = k // 2
    lo = q[:, :half]
    hi = q[:, half:] ^ 0x8
    return ((hi << 4) | lo).astype(np.uint8), scale, zp


def quantize_pack_planar(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-row INT4 quantize + planar pack of [n, k] float32.

    Returns (packed [n, k/2] u8, scales [n] f32, zero_points [n] f32) in the
    Pallas kernel layout (quant.core.pack_planar).
    """
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    if k % 2:
        raise ValueError("k must be even")
    lib = _load()
    if lib is None:
        return _numpy_quantize_pack(w)
    packed = np.empty((n, k // 2), np.uint8)
    scales = np.empty((n,), np.float32)
    zps = np.empty((n,), np.float32)
    lib.quantize_pack_planar_f32(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(k),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        zps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return packed, scales, zps


def dequantize_planar(packed: np.ndarray, scales: np.ndarray, zps: np.ndarray):
    """Host-side inverse of :func:`quantize_pack_planar`."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, half = packed.shape
    k = half * 2
    lib = _load()
    if lib is None:
        lo = (packed & 0x0F).astype(np.float32)
        hi = ((packed >> 4) ^ 0x8).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)
        return (q - zps[:, None]) * scales[:, None]
    out = np.empty((n, k), np.float32)
    lib.dequantize_planar_f32(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int64(k),
        np.ascontiguousarray(scales, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
        np.ascontiguousarray(zps, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
