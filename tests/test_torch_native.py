"""The port's native library against the JAX package's, on the CPU: the
float64 oracles, the C++ prefetcher and ``ArrayLoader``'s
``native_prefetch``, and the build under its lock.

Both packages bind the same C sources (``native/src``). The JAX side loads
its own ``native/libiftnative.so`` where ``make`` has built it; where it
has not, the test points it at the port's build of the same sources
rather than let it run ``make`` (several test workers would run it at
once). Tolerances: none, every comparison is exact.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import inverse_flow_tpu.native as jnative
import torch_workers as w
from inverse_flow_tpu.data import loader as jloader
from inverse_flow_tpu_torch import native as tnative
from inverse_flow_tpu_torch.data import loader as tloader
from inverse_flow_tpu_torch.ops.inv_conv import apply_mask


@pytest.fixture
def jax_native(monkeypatch):
    """JAX's ``native`` module with a library loaded, never by ``make``."""
    if jnative._LIB is None and not os.path.exists(jnative._lib_path()):
        monkeypatch.setattr(jnative, "_lib_path", tnative.build)
    assert jnative.available() and tnative.available()
    return jnative


def _operands(groups, seed=0):
    """An input and a masked kernel (each group's block masked, as
    ``tests/test_native.py`` builds them)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 4, 6, 5)
    cg = 4 // groups
    k = np.concatenate([apply_mask(torch.from_numpy(
        0.3 * rs.randn(cg, cg, 3, 3))).numpy() for _ in range(groups)])
    return x, k


@pytest.mark.parametrize("groups", [1, 2])
def test_oracles_match_jax(groups, jax_native):
    """``masked_conv`` and ``inv_conv_solve`` equal JAX's bit for bit, and
    invert each other to float64 round-off."""
    x, k = _operands(groups)
    z = tnative.masked_conv(x, k, groups)
    np.testing.assert_array_equal(z, jax_native.masked_conv(x, k, groups))
    y = tnative.inv_conv_solve(x, k, groups)
    np.testing.assert_array_equal(y, jax_native.inv_conv_solve(x, k, groups))
    np.testing.assert_allclose(tnative.masked_conv(y, k, groups), x,
                               atol=1e-12)
    with pytest.raises(ValueError, match="groups"):
        tnative.masked_conv(x, k, 3)


def test_prefetcher_matches_jax(jax_native):
    """The same seed gives JAX's batches, across epoch boundaries (each
    epoch reshuffled)."""
    data = np.random.RandomState(1).randint(0, 256, (50, 3, 4, 4)).astype(
        np.uint8)
    ours = tnative.NativePrefetcher(data, 8, shuffle=True, seed=5)
    ref = jax_native.NativePrefetcher(data, 8, shuffle=True, seed=5)
    assert ours.batches_per_epoch == ref.batches_per_epoch == 6
    for _ in range(2 * ours.batches_per_epoch + 1):
        np.testing.assert_array_equal(ours.next(), ref.next())
    ours.close()
    ref.close()
    with pytest.raises(ValueError, match="samples < batch_size"):
        tnative.NativePrefetcher(data[:4], 8)


@pytest.mark.parametrize("native_prefetch", [None, True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_array_loader_native_prefetch_matches_jax(native_prefetch, dtype,
                                                  jax_native):
    """``native_prefetch`` None (the auto rule), True and False give JAX's
    batches for integral data, over two epochs, with an augmentation; auto
    takes the C++ thread for shuffled uint8-valued data."""
    data = np.random.RandomState(2).randint(0, 256, (30, 1, 4, 4)).astype(
        dtype)
    kw = dict(shuffle=True, seed=3, native_prefetch=native_prefetch)
    ours = tloader.ArrayLoader(data, 4, augment=tloader.random_flip_lr, **kw)
    ref = jloader.ArrayLoader(data, 4, augment=jloader.random_flip_lr, **kw)
    assert (ours._prefetcher is not None) == (native_prefetch is not False)
    assert (ref._prefetcher is not None) == (ours._prefetcher is not None)
    for _ in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.float32


@pytest.mark.parametrize("case", ["fractional", "few", "partial"])
def test_array_loader_native_prefetch_raises_as_jax(case, jax_native):
    """Forced prefetch refuses what the C++ worker cannot honour, as JAX
    does; the auto rule then takes the numpy path instead."""
    rs = np.random.RandomState(4)
    data = {"fractional": rs.rand(12, 1, 2, 2) * 255,
            "few": rs.randint(0, 256, (3, 1, 2, 2)).astype(np.float32),
            "partial": rs.randint(0, 256, (10, 1, 2, 2)).astype(np.uint8)}[
        case]
    kw = dict(drop_last=case != "partial", shuffle=True)
    errors = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError) as e:
            mod.ArrayLoader(data, 4, native_prefetch=True, **kw)
        errors.append(str(e.value))
        assert mod.ArrayLoader(data, 4, native_prefetch=None, **kw) \
            ._prefetcher is None
    assert errors[0] == errors[1]


def test_concurrent_build_under_the_lock(tmp_path):
    """Four processes that ask for the library at once in an empty build
    directory all load it: one build, no temporary file left."""
    build_dir = str(tmp_path / "native")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        out = pool.map_async(w.native_library, [build_dir] * 4).get(
            timeout=120)
    assert [ok for ok, _ in out] == [True] * 4
    assert len({path for _, path in out}) == 1
    assert sorted(os.listdir(build_dir)) == [".lock",
                                             os.path.basename(out[0][1])]


def test_build_without_openmp(tmp_path, monkeypatch):
    """A compiler that refuses the OpenMP flag (as one without libgomp
    does) builds the serial library, whose oracles give the same
    results."""
    monkeypatch.setattr(tnative, "OPENMP", "-fno-such-openmp-flag")
    path = tnative.build(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [".lock", os.path.basename(path)]
    lib = tnative._load(str(tmp_path))
    assert lib is not None and lib.ift_num_threads() == 1
    x, k = _operands(2)
    args, (_, _, y) = tnative._solve_args(x, k, 2)
    lib.ift_inv_conv_solve_f64(*args)
    np.testing.assert_array_equal(y, tnative.inv_conv_solve(x, k, 2))


def test_native_build_is_the_ports_own():
    """The library is built under ``build/``, from ``native/src``, and never
    into ``native/``."""
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.sep + "build" + os.sep in path
    assert all(os.path.exists(s) for s in tnative.SOURCES)
