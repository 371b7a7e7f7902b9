"""ctypes loader for the native C++ counting engine. The port's copy of
``fruitnerf_tpu/native/__init__.py``, with its own copy of the source.

The reference's counting stage runs on native code (Open3D C++ ops,
clustering_base.py:183-207; sklearn's Cython DBSCAN :200). This package is
the equivalent runtime piece here: `src/fruitnerf_native.cpp` compiled to a
shared library on first use (g++; no pybind11 — plain C ABI via ctypes)
into ``fruitnerf_tpu_torch/_build/native/<source hash>/``, never into the
source tree. All callers fall back to the pure-Python engines when the
toolchain is missing or `FRUITNERF_NO_NATIVE=1` is set, so the native path
is an accelerator, never a hard dependency.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "fruitnerf_native.cpp"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_tried = False
_SO: Path | None = None  # the loaded library's path


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    key = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return Path(__file__).resolve().parents[1] / "_build" / "native" / key / "libfruitnerf_native.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 or not tmp.exists():
        return False
    os.replace(tmp, so)  # atomic: a racing build finds a whole file
    return True


def load():
    """The loaded library, or None (unavailable / disabled / build failed)."""
    global _lib, _tried, _SO
    if os.environ.get("FRUITNERF_NO_NATIVE"):
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fn_neighbor_counts.argtypes = [pf, i64, f32, pi]
    lib.fn_neighbor_counts.restype = ctypes.c_int
    lib.fn_radius_outlier.argtypes = [pf, i64, f32, i32, pu8]
    lib.fn_radius_outlier.restype = ctypes.c_int
    lib.fn_dbscan.argtypes = [pf, i64, f32, i32, pi]
    lib.fn_dbscan.restype = ctypes.c_int
    lib.fn_voxel_downsample.argtypes = [pf, i64, f32, pf, pi64, pi64]
    lib.fn_voxel_downsample.restype = ctypes.c_int
    _lib, _SO = lib, so
    return _lib


def _as_f32(points: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(points, dtype=np.float32)


def neighbor_counts(points: np.ndarray, radius: float) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    pts = _as_f32(points)
    out = np.empty(len(pts), np.int32)
    if lib.fn_neighbor_counts(pts, len(pts), radius, out) != 0:
        return None
    return out


def radius_outlier_mask(
    points: np.ndarray, radius: float, nb_points: int
) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    pts = _as_f32(points)
    keep = np.empty(len(pts), np.uint8)
    if lib.fn_radius_outlier(pts, len(pts), radius, nb_points, keep) != 0:
        return None
    return keep.astype(bool)


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    pts = _as_f32(points)
    labels = np.empty(len(pts), np.int32)
    if lib.fn_dbscan(pts, len(pts), eps, min_samples, labels) != 0:
        return None
    return labels


def voxel_downsample(
    points: np.ndarray, voxel: float
) -> tuple[np.ndarray, np.ndarray] | None:
    """Returns (means [m,3] f32, voxel keys [m,3] i64) in hash order; the
    exact integer keys let callers sort deterministically (deriving keys from
    the rounded float means can land boundary voxels in the neighbor cell)."""
    lib = load()
    if lib is None:
        return None
    pts = _as_f32(points)
    out = np.empty_like(pts)
    keys = np.empty((len(pts), 3), np.int64)
    out_n = np.zeros(1, np.int64)
    if lib.fn_voxel_downsample(pts, len(pts), voxel, out, keys, out_n) != 0:
        return None
    m = int(out_n[0])
    return out[:m].copy(), keys[:m].copy()
