"""ctypes bindings of the native C++ runtime (counterpart of
``cpppathtracer_tpu/utils/native.py``): the median-split BVH build, RGB to
BGRA8 packing and a zlib PNG writer, from the repository's
``native/poca_native.cpp``.

The port builds its own copy of that source with g++ into
``cpppathtracer_tpu_torch/_build/native/<hash of source and flags>/`` at
first use, under a thread lock and a file lock, and never writes into
``native/``.  Where no library can be built or loaded, :func:`available`
says False, and callers take their NumPy paths (``ops/bvh.build_bvh``
falls back to ``build_bvh_numpy``, which gives the same arrays).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "poca_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None
_error = None  # why the library could not be built or loaded, once it failed


def _build() -> Path:
    """Compile SOURCE if this source and flag hash has no library yet;
    return the library's path.  Concurrent processes serialise on a lock
    file, and the library appears under its name only when complete."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16]
    lib = out / "libpoca_native.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            fd, tmp = tempfile.mkstemp(dir=out, suffix=".so")
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lz"],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(f"the native library is unavailable: {_error}")
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            _error = e
            raise RuntimeError(f"the native library is unavailable: {e}") from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.poca_bvh_build.restype = ctypes.c_int
        lib.poca_bvh_build.argtypes = [ctypes.c_int, f32p, f32p, i32p, i32p, i32p, f32p, f32p]
        lib.poca_pack_bgra8.restype = None
        lib.poca_pack_bgra8.argtypes = [f32p, ctypes.c_int, u8p]
        lib.poca_png_write.restype = ctypes.c_long
        lib.poca_png_write.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is built and loaded (building it now if
    need be).  False means callers run their NumPy fallbacks."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray) -> dict:
    """The native median-split build; the arrays of
    ``ops.bvh.build_bvh_numpy`` (left, right, obj_idx, aabb_min,
    aabb_max)."""
    lib = _load()
    n = aabb_min.shape[0]
    cap = max(2 * n, 1)
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    obj = np.empty(cap, np.int32)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    m = lib.poca_bvh_build(n, amin, amax, left, right, obj, nmin, nmax)
    if m < 0:
        raise RuntimeError("poca_bvh_build failed")
    if m == 0:
        return {
            "left": np.array([-1], np.int32),
            "right": np.array([-1], np.int32),
            "obj_idx": np.array([-1], np.int32),
            "aabb_min": np.full((1, 3), np.inf, np.float32),
            "aabb_max": np.full((1, 3), -np.inf, np.float32),
        }
    return {
        "left": left[:m].copy(),
        "right": right[:m].copy(),
        "obj_idx": obj[:m].copy(),
        "aabb_min": nmin[:m].copy(),
        "aabb_max": nmax[:m].copy(),
    }


def pack_bgra8(rgb: np.ndarray) -> np.ndarray:
    """f32[..., 3] clamped to [0, 1], to u8[..., 4] B, G, R, 255 (x255.99,
    the reference's frame bytes, `path_tracer.cu:251-253`)."""
    lib = _load()
    flat = np.ascontiguousarray(rgb, np.float32).reshape(-1, 3)
    out = np.empty((flat.shape[0], 4), np.uint8)
    lib.poca_pack_bgra8(flat, flat.shape[0], out)
    return out.reshape(rgb.shape[:-1] + (4,))


def write_png(path, rgb8: np.ndarray) -> None:
    """Write u8[H, W, 3] as a PNG."""
    lib = _load()
    img = np.ascontiguousarray(rgb8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes u8[H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    if lib.poca_png_write(img, w, h, str(path).encode()) < 0:
        raise RuntimeError(f"poca_png_write failed for {path}")
