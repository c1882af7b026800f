"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for Hopper (sm_90a) into ``build/kernels/`` at the root of the
checkout on first use, under a name that carries a hash of the source (so
an edited source is never served by a stale library), and loaded with
``ctypes``. ``nvcc`` runs with ``-Xptxas -v``: each kernel's registers,
shared memory and spills go to ``lib<name>_<hash>.log`` beside the library
(:func:`build_log`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if needed; returns the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              check=True, capture_output=True, text=True)
        with open(out[:-len(".so")] + ".log", "w") as f:
            f.write(done.stderr)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {src}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_log(name: str) -> str:
    """What ``ptxas -v`` said when ``csrc/<name>.cu`` was built: each
    kernel's registers, shared memory and spills."""
    with open(build(name)[:-len(".so")] + ".log") as f:
        return f.read()


@functools.cache
def _chain_solve_cdll() -> ctypes.CDLL:
    lib = ctypes.CDLL(build("chain_solve"))
    lib.chain_phases_init.argtypes = []
    lib.chain_phases_init.restype = ctypes.c_int
    for fn in (lib.chain_phases_f32, lib.chain_phases_cluster_f32,
               lib.chain_phases_cluster_wide_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    occ = lib.chain_phases_cluster_occupancy
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    plan = lib.chain_phases_cluster_wide_plan
    plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    return lib


@functools.cache
def chain_solve_lib(device_index: int) -> ctypes.CDLL:
    """``csrc/chain_solve.cu``, built and loaded once per process, with the
    kernels' shared memory limits raised once on CUDA device
    ``device_index``, which must be the current device."""
    lib = _chain_solve_cdll()
    err = lib.chain_phases_init()
    if err != 0:
        raise RuntimeError(f"chain_phases_init failed with CUDA error {err}")
    return lib


@functools.cache
def slr_inverse_lib() -> ctypes.CDLL:
    """``csrc/slr_inverse.cu`` (the smooth leaky ReLU's and the smooth
    tanh's Newton inverses), built and loaded once per process."""
    lib = ctypes.CDLL(build("slr_inverse"))
    ptrs = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    for fn in (lib.slr_inverse_f32, lib.slr_inverse_fixed_f32):
        fn.argtypes = ptrs + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.smooth_tanh_inverse_f32,
               lib.smooth_tanh_inverse_step_exit_f32):
        fn.argtypes = ptrs + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def bspline_inverse_lib() -> ctypes.CDLL:
    """``csrc/bspline_inverse.cu`` (the monotone cubic B-spline's inverse:
    the bracketed Newton kernels and the first design), built and loaded
    once per process."""
    lib = ctypes.CDLL(build("bspline_inverse"))
    fn = lib.bspline_inverse_f32
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.bspline_inverse_first_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cluster_occupancy(device_index: int, b: int, rcw: int, kcw: int) -> int:
    """How many clusters of the chain's cluster kernel can be resident at
    once on CUDA device ``device_index`` (the current device) at this
    shape; a launch at batch ``b`` needs ceil(b / 8)."""
    lib = chain_solve_lib(device_index)
    n = ctypes.c_int(0)
    err = lib.chain_phases_cluster_occupancy(b, rcw, kcw, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"chain_phases_cluster_occupancy failed with CUDA "
                           f"error {err}")
    return n.value


def cluster_wide_plan(device_index: int, b: int, rcw: int, kcw: int) -> dict:
    """The wide cluster kernel's launch plan on CUDA device
    ``device_index`` (the current device) at batch ``b``: row groups of 8
    a cluster, chunk buffers (0: resident slices), k-columns a chunk,
    shared memory bytes a CTA, clusters resident at once and clusters the
    launch needs."""
    lib = chain_solve_lib(device_index)
    out = (ctypes.c_int * 6)()
    err = lib.chain_phases_cluster_wide_plan(b, rcw, kcw, out)
    if err != 0:
        raise RuntimeError(f"chain_phases_cluster_wide_plan failed with CUDA "
                           f"error {err}")
    return dict(zip(("groups", "stages", "chunk", "smem", "active",
                     "needed"), out))


@functools.cache
def coupling_net_lib() -> ctypes.CDLL:
    """``csrc/coupling_net.cu`` (a coupling net's conv3x3 -> ReLU ->
    conv1x1, forward, backward and the weight gradients' reduction), built
    and loaded once per process."""
    lib = ctypes.CDLL(build("coupling_net"))
    shape = [ctypes.c_int] * 6
    lib.coupling_net_plan.argtypes = shape + [ctypes.POINTER(ctypes.c_int)]
    lib.coupling_net_plan.restype = ctypes.c_int
    lib.coupling_net_fwd_f32.argtypes = ([ctypes.c_void_p] * 4 + shape
                                         + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
    lib.coupling_net_fwd_f32.restype = ctypes.c_int
    lib.coupling_net_bwd_f32.argtypes = ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int] * 2 + shape
                                         + [ctypes.c_longlong,
                                            ctypes.c_void_p])
    lib.coupling_net_bwd_f32.restype = ctypes.c_int
    lib.coupling_net_reduce_f32.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 3 + shape
                                            + [ctypes.c_void_p])
    lib.coupling_net_reduce_f32.restype = ctypes.c_int
    return lib
