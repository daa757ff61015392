"""ctypes bridge to the native C++ loader (native/loader.cpp, prefetch.cpp).

The shared library is built from the committed sources at first use: `g++`
compiles `native/*.cpp` into `build/native/libsaccot_native.so` under the
repository root (a path .gitignore lists), and rebuilds it when a source is
newer. `native/build.sh` runs the same build by hand. Every function
returns None when no library can be built or loaded, so callers fall back
to the NumPy paths in io/loaders.py — the framework never *requires* it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_ROOT, "native")
LIB_PATH = os.path.join(_ROOT, "build", "native", "libsaccot_native.so")

_LIB = None
_TRIED = False


def build(lib_path: str = LIB_PATH) -> Optional[str]:
    """Compile native/*.cpp into `lib_path` if missing or stale.

    Returns the library path, or None when there is no compiler or the
    build fails. Safe to race: each build writes its own temporary file and
    renames it into place.
    """
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))
    if not srcs:
        return None
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= max(
        os.path.getmtime(s) for s in srcs
    ):
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", *srcs, "-o", tmp,
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, lib_path)
    return lib_path


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.saccot_load_kitti_bin.restype = ctypes.c_long
    lib.saccot_load_kitti_bin.argtypes = [ctypes.c_char_p, fp, ctypes.c_long]
    lib.saccot_load_ply_xyz.restype = ctypes.c_long
    lib.saccot_load_ply_xyz.argtypes = [ctypes.c_char_p, fp, ctypes.c_long]
    lib.saccot_voxel_downsample.restype = ctypes.c_long
    lib.saccot_voxel_downsample.argtypes = [fp, ctypes.c_long, ctypes.c_float, fp, ctypes.c_long]
    cpp = ctypes.POINTER(ctypes.c_char_p)
    lib.saccot_prefetch_create.restype = ctypes.c_void_p
    lib.saccot_prefetch_create.argtypes = [
        cpp, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.saccot_prefetch_next.restype = ctypes.c_long
    lib.saccot_prefetch_next.argtypes = [ctypes.c_void_p, fp, ctypes.c_long]
    lib.saccot_prefetch_destroy.restype = None
    lib.saccot_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def _farray(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_kitti_bin(path: str, max_pts: int = 200_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_pts, 3), np.float32)
    n = lib.saccot_load_kitti_bin(path.encode(), _farray(out), max_pts)
    if n < 0:
        return None
    return out[:n].copy()


def load_ply_xyz(path: str, max_pts: int = 2_000_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_pts, 3), np.float32)
    n = lib.saccot_load_ply_xyz(path.encode(), _farray(out), max_pts)
    if n < 0:
        return None
    return out[:n].copy()


def voxel_downsample(points: np.ndarray, voxel: float, max_out: int = 500_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((max_out, 3), np.float32)
    m = lib.saccot_voxel_downsample(_farray(pts), len(pts), voxel, _farray(out), max_out)
    if m < 0:
        return None
    return out[:m].copy()


class PrefetchReader:
    """Background-threaded ordered scan reader (native/prefetch.cpp).

    Iterates the given files in order, yielding [n, 3] float32 arrays (or
    None for unreadable files), while a native worker pool parses up to
    `window` scans ahead of the consumer — so disk/parse latency overlaps
    device compute in the sweep runner. Use `prefetch_reader()` to get
    either this or None when the native library is unavailable.
    """

    def __init__(self, paths, fmt: str, max_pts: int = 200_000,
                 threads: int = 4, window: int = 8):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native prefetcher unavailable")
        self._lib = lib
        self._paths = [str(p) for p in paths]
        self._max_pts = int(max_pts)
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        fmt_code = {"kitti": 0, "bin": 0, "ply": 1}[fmt]
        self._h = lib.saccot_prefetch_create(
            arr, len(self._paths), self._max_pts, fmt_code, threads, window
        )
        if not self._h:
            raise RuntimeError("prefetcher creation failed")

    def __iter__(self):
        out = np.empty((self._max_pts, 3), np.float32)
        for _ in range(len(self._paths)):
            n = self._lib.saccot_prefetch_next(self._h, _farray(out), self._max_pts)
            if n == -2:
                return
            yield None if n < 0 else out[:n].copy()

    def close(self):
        if self._h:
            self._lib.saccot_prefetch_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def prefetch_reader(paths, fmt: str, max_pts: int = 200_000,
                    threads: int = 4, window: int = 8) -> Optional["PrefetchReader"]:
    """PrefetchReader when the native library is available, else None."""
    if _lib() is None:
        return None
    return PrefetchReader(paths, fmt, max_pts=max_pts, threads=threads, window=window)
