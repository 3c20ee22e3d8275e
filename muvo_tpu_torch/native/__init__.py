"""Native host data-path kernels (C++, ctypes-bound) with numpy fallback.

An own copy of muvo_tpu/native/__init__.py (``range_view.cpp`` is the same
file byte for byte). The one difference: the library builds on first use
(g++ -O3) into ``build/muvo_tpu_torch/`` at the root of the checkout
(git-ignored, beside the CUDA libraries of ops/_build.py), named by a hash
of the source, the flags and the host CPU's features (``-march=native``
code must not load on another CPU), never beside its source. The input
pipeline uses these for the per-frame hot loops; everything degrades to
the numpy implementations when no compiler is available. This is host
code: no device and no kernel of the port is behind the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "range_view.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "muvo_tpu_torch"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_features() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_cpu_features().encode())
    return BUILD_DIR / f"lib_muvo_native-{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: processes building at once
    # never load a half-written library
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        result = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if result.returncode != 0:
        return False
    os.replace(tmp, lib_path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.is_file() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")

        lib.range_project.argtypes = [
            f32p, u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, f32p, f32p, f32p, u8p,
        ]
        lib.range_project.restype = None
        lib.densify_voxels.argtypes = [
            u16p, u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p,
        ]
        lib.densify_voxels.restype = None
        lib.decode_depth.argtypes = [u8p, ctypes.c_int64, f32p]
        lib.decode_depth.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def range_project(points: np.ndarray, sems: np.ndarray, h: int, w: int,
                  fov_down_rad: float, fov_up_rad: float,
                  lidar_pos) -> Optional[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]]:
    """Returns (depth (h,w) f32, xyz (h,w,3) f32, sem (h,w) u8) or None."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    sem = np.ascontiguousarray(sems, np.uint8)
    depth = np.empty((h, w), np.float32)
    xyz = np.empty((h, w, 3), np.float32)
    out_sem = np.empty((h, w), np.uint8)
    pos = np.ascontiguousarray(np.asarray(lidar_pos, np.float32))
    lib.range_project(pts, sem, pts.shape[0], h, w,
                      np.float32(fov_down_rad), np.float32(fov_up_rad),
                      pos, depth, xyz, out_sem)
    return depth, xyz, out_sem


def densify_voxels(coords: np.ndarray, sems: np.ndarray,
                   grid_size) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(coords, np.uint16)
    s = np.ascontiguousarray(sems, np.uint8)
    x, y, z = (int(v) for v in grid_size)
    grid = np.empty((x, y, z), np.uint8)
    lib.densify_voxels(c, s, c.shape[0], x, y, z, grid)
    return grid


def decode_depth(rgb: np.ndarray) -> Optional[np.ndarray]:
    """(..., 3) uint8 RGB -> metres (float32)."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(rgb.reshape(-1, 3), np.uint8)
    out = np.empty(flat.shape[0], np.float32)
    lib.decode_depth(flat, flat.shape[0], out)
    return out.reshape(rgb.shape[:-1])
