"""ctypes bindings for the repository's native C++ library: the float64
oracles of the masked conv and its raster solve, and the threaded
shuffled-batch prefetcher.

Port of ``inverse_flow_tpu/native.py`` over the same C API, with a build
of its own: ``g++`` compiles ``native/src/wavefront.cpp`` and
``native/src/prefetch.cpp`` (the Makefile's flags) into
``build/native/libiftnative_<hash>.so`` at the root of the checkout, under
an ``fcntl`` lock, to a temporary name that is then renamed into place;
the hash is of the sources, so an edited source is never served by a stale
library. A compiler without OpenMP builds the oracles serially (each
output is computed alone, so the results are the same). It never runs
``make`` and never writes ``native/``. If the library cannot be built,
:func:`available` is False and callers take their numpy paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_ROOT, "native", "src", f)
                for f in ("wavefront.cpp", "prefetch.cpp"))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
OPENMP = "-fopenmp"


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the library into ``build_dir`` if it is not there; returns
    its path. Concurrent callers wait on the lock and load one build."""
    digest = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build_dir, f"libiftnative_{digest.hexdigest()[:12]}"
                                  ".so")
    if os.path.exists(out):
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "library")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # built while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            for flags in ((*CXXFLAGS, OPENMP), CXXFLAGS):
                done = subprocess.run([cxx, *flags, *SOURCES, "-o", tmp],
                                      capture_output=True, text=True,
                                      timeout=300)
                if done.returncode == 0:
                    os.replace(tmp, out)
                    return out
            raise RuntimeError(f"g++ failed on the native library:\n"
                               f"{done.stderr}")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


@functools.cache
def _load(build_dir: str) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(build(build_dir))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    i64, u64, p8, pd, pv = (ctypes.c_int64, ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)
    lib.ift_masked_conv_f64.argtypes = [pd, pd, pd] + [i64] * 7
    lib.ift_masked_conv_f64.restype = None
    lib.ift_inv_conv_solve_f64.argtypes = [pd, pd, pd] + [i64] * 7
    lib.ift_inv_conv_solve_f64.restype = None
    lib.ift_num_threads.argtypes = []
    lib.ift_num_threads.restype = ctypes.c_int
    lib.ift_prefetch_create.restype = pv
    lib.ift_prefetch_create.argtypes = [p8, i64, i64, i64, ctypes.c_int,
                                        u64, i64]
    lib.ift_prefetch_next.argtypes = [pv, p8]
    lib.ift_prefetch_next.restype = ctypes.c_int
    lib.ift_prefetch_batches_per_epoch.argtypes = [pv]
    lib.ift_prefetch_batches_per_epoch.restype = i64
    lib.ift_prefetch_destroy.argtypes = [pv]
    lib.ift_prefetch_destroy.restype = None
    return lib


def available(build_dir: str = BUILD_DIR) -> bool:
    """Whether the library is built (building it now if needed) and
    loads."""
    return _load(build_dir) is not None


def _lib():
    lib = _load(BUILD_DIR)
    if lib is None:
        raise RuntimeError("the native library is unavailable (no g++, or "
                           "its build failed)")
    return lib


def _solve_args(x, k, groups):
    x = np.ascontiguousarray(x, dtype=np.float64)
    k = np.ascontiguousarray(k, dtype=np.float64)
    if x.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected (B, C, H, W) and (C, C/groups, kh, kw), "
                         f"got {x.shape} and {k.shape}")
    b, c, h, w = x.shape
    if c % groups or k.shape[:2] != (c, c // groups):
        raise ValueError(f"kernel {k.shape} does not fit {c} channels in "
                         f"{groups} groups")
    pd = ctypes.POINTER(ctypes.c_double)
    out = np.zeros_like(x)
    return (x.ctypes.data_as(pd), k.ctypes.data_as(pd), out.ctypes.data_as(pd),
            b, c, h, w, k.shape[2], k.shape[3], groups), (x, k, out)


def masked_conv(y, k, groups=1):
    """float64 oracle of the TL masked conv (z = T y)."""
    args, (_, _, z) = _solve_args(y, k, groups)
    _lib().ift_masked_conv_f64(*args)
    return z


def inv_conv_solve(x, k, groups=1):
    """float64 oracle of the raster back-substitution (y = T^{-1} x)."""
    args, (_, _, y) = _solve_args(x, k, groups)
    _lib().ift_inv_conv_solve_f64(*args)
    return y


class NativePrefetcher:
    """Full batches of a uint8 dataset, gathered (and shuffled each epoch
    by the library's own generator, from ``seed``) on a C++ thread that
    keeps ``capacity`` batches ready."""

    def __init__(self, data: np.ndarray, batch_size: int, shuffle=True,
                 seed=0, capacity=4):
        self._handle = None
        self._lib = _lib()
        self._data = np.ascontiguousarray(data, dtype=np.uint8)
        n = self._data.shape[0]
        if n < batch_size:
            raise ValueError(
                f"NativePrefetcher: {n} samples < batch_size={batch_size} "
                f"(the worker assembles full batches only)")
        self.item_shape = self._data.shape[1:]
        self.batch_size = batch_size
        self._handle = self._lib.ift_prefetch_create(
            self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            int(np.prod(self.item_shape)), batch_size, int(shuffle), seed,
            capacity)
        self.batches_per_epoch = int(
            self._lib.ift_prefetch_batches_per_epoch(self._handle))

    def next(self) -> np.ndarray:
        out = np.empty((self.batch_size,) + tuple(self.item_shape), np.uint8)
        rc = self._lib.ift_prefetch_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise RuntimeError(
                "NativePrefetcher: the worker thread exited with no batch "
                "available (stopped or invalid geometry)")
        return out

    def close(self):
        if self._handle:
            self._lib.ift_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
