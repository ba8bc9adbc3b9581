"""Native (C++) host runtime components, loaded with ctypes.

A copy of ``tpu_rt/native``: a median-split BVH builder with skip-link
export and a stackless CPU traversal, for instant selection raycasts and
as an oracle independent of the port's LBVH (``ops/bvh.py``) in tests.

The shared library is compiled with g++ at first use (a plain C interface,
no PyTorch headers) into ``build/tpu_rt_torch/`` beside the package, named
by a hash of the source and flags; the compiler writes to a temporary file
that is renamed into place, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_rt_torch"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

T_MAX = 1e10


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"_tpurt_native_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> Optional[str]:
    """g++ -O3 -shared into ``so``; returns an error string or None."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
        os.unlink(tmp)
        return str(e)
    if proc.returncode != 0:
        os.unlink(tmp)
        return proc.stderr
    os.replace(tmp, so)
    return None


def load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        so = _library_path()
        if not so.exists():
            err = _compile(so)
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(so))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.tpurt_bvh_build.restype = ctypes.c_int32
        lib.tpurt_bvh_build.argtypes = [
            f32p, f32p, ctypes.c_int32, ctypes.c_int32, f32p, i32p, i32p,
        ]
        lib.tpurt_bvh_intersect_spheres.restype = None
        lib.tpurt_bvh_intersect_spheres.argtypes = [
            f32p, i32p, i32p, ctypes.c_int32, f32p, f32p, f32p, f32p,
            ctypes.c_int32, ctypes.c_float, ctypes.c_float, f32p, i32p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


class HostBVH:
    """Median-split BVH built natively; see bvh_builder.cpp."""

    def __init__(self, bb_min: np.ndarray, bb_max: np.ndarray,
                 leaf_size: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        bb_min = np.ascontiguousarray(bb_min, np.float32)
        bb_max = np.ascontiguousarray(bb_max, np.float32)
        n = bb_min.shape[0]
        self.bounds = np.empty((2 * n - 1, 6), np.float32)
        self.meta = np.empty((2 * n - 1, 3), np.int32)
        self.order = np.empty((n,), np.int32)
        count = lib.tpurt_bvh_build(bb_min, bb_max, n, leaf_size,
                                    self.bounds, self.meta, self.order)
        if count < 0:
            raise ValueError("bad BVH input")
        self.node_count = int(count)
        self.bounds = self.bounds[: self.node_count]
        self.meta = self.meta[: self.node_count]

    @classmethod
    def from_spheres(cls, centers, radii, leaf_size: int = 4) -> "HostBVH":
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        radii = np.asarray(radii, np.float32).reshape(-1)
        return cls(centers - radii[:, None], centers + radii[:, None],
                   leaf_size)

    def intersect_spheres(self, centers, radii, origins, directions,
                          t_min: float = 1e-3, t_max: float = T_MAX):
        """Closest-hit batch query; returns (t, prim_index) arrays."""
        lib = load()
        centers = np.ascontiguousarray(centers, np.float32)
        radii = np.ascontiguousarray(radii, np.float32)
        origins = np.ascontiguousarray(origins, np.float32)
        directions = np.ascontiguousarray(directions, np.float32)
        r = origins.shape[0]
        out_t = np.empty((r,), np.float32)
        out_prim = np.empty((r,), np.int32)
        lib.tpurt_bvh_intersect_spheres(
            self.bounds, self.meta, self.order, self.node_count,
            centers, radii, origins, directions, r,
            np.float32(t_min), np.float32(t_max), out_t, out_prim,
        )
        return out_t, out_prim
