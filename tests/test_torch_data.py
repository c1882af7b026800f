"""The port's data loaders and config against the JAX package's.

The port has its own numpy-only copies of the loaders (MNIST, ImageNet,
synthetic, the toy densities, galaxy), so that it imports nothing of the
JAX package. They must give the same arrays and the same batches,
exactly: on the numpy path (``native_prefetch=False`` on both sides) and,
for the loaders that shuffle uint8 data, on the native prefetcher that
both take by default when the library is present (the JAX side on a
library that ``make`` did not build now: ``test_torch_native.py``'s
``jax_native`` fixture).
"""

import dataclasses
import gzip
import inspect
import os

import numpy as np
import pytest
import torch

from inverse_flow_tpu.data import galaxy as jgalaxy
from inverse_flow_tpu.data import imagenet as jimagenet
from inverse_flow_tpu.data import loader as jloader
from inverse_flow_tpu.data import mnist as jmnist
from inverse_flow_tpu.data import synthetic as jsynthetic
from inverse_flow_tpu.data import toy as jtoy
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu_torch.data import galaxy as tgalaxy
from inverse_flow_tpu_torch.data import imagenet as timagenet
from inverse_flow_tpu_torch.data import loader as tloader
from inverse_flow_tpu_torch.data import mnist as tmnist
from inverse_flow_tpu_torch.data import synthetic as tsynthetic
from inverse_flow_tpu_torch.data import toy as ttoy
from inverse_flow_tpu_torch.distributions import GaussianPrior
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.train.memory import MemoryTracker

from test_torch_native import jax_native  # noqa: F401  (a fixture)


def _batches(loader):
    return [b.copy() for b in loader]


def _assert_same_batches(ours, ref):
    assert len(ours) == len(ref)
    assert ours.data_shape == ref.data_shape
    a, b = _batches(ours), _batches(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape,seed", [((1, 28, 28), 0), ((3, 8, 6), 7)])
def test_smooth_images_match_jax(shape, seed):
    np.testing.assert_array_equal(tsynthetic.smooth_images(5, shape, seed),
                                  jsynthetic.smooth_images(5, shape, seed))


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (11, 4, False, False), (11, 4, False, True), (3, 4, False, True),
    (12, 4, True, True), (13, 5, True, False)])
def test_array_loader_matches_jax(n, batch, shuffle, drop_last):
    data = np.random.RandomState(n).randint(0, 256, (n, 1, 3, 3))
    data = data.astype(np.float32)
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last)
    ours = tloader.ArrayLoader(data, batch, native_prefetch=False, **kw)
    ref = jloader.ArrayLoader(data, batch, native_prefetch=False, **kw)
    for _ in range(2):                  # a second epoch reshuffles
        _assert_same_batches(ours, ref)


def _write_idx(path, arr):
    head = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("files", [False, True])
def test_mnist_load_data_matches_jax(files, tmp_path, monkeypatch):
    """Without the idx files both fall back to the same synthetic split;
    with them both read the same images and split them alike."""
    monkeypatch.setenv("IFT_DATA_DIR", str(tmp_path))
    if files:
        os.makedirs(tmp_path / "mnist")
        rs = np.random.RandomState(0)
        _write_idx(tmp_path / "mnist" / "train-images-idx3-ubyte.gz",
                   rs.randint(0, 256, (30, 28, 28)))
        _write_idx(tmp_path / "mnist" / "t10k-images-idx3-ubyte.gz",
                   rs.randint(0, 256, (7, 28, 28)))
        kw = dict(batch_size=4, train_split=20)
        ours, ref = tmnist.load_data(**kw), jmnist.load_data(**kw)
    else:
        with pytest.warns(UserWarning, match="synthetic"):
            ours = tmnist.load_data(batch_size=100)
        with pytest.warns(UserWarning, match="synthetic"):
            ref = jmnist.load_data(batch_size=100)
    np.testing.assert_array_equal(ours[0].data, ref[0].data)
    assert ours[0].shuffle and ours[0].drop_last
    for a, b in zip(ours[1:], ref[1:]):
        _assert_same_batches(a, b)


def test_experiment_config_defaults_match_jax():
    assert ([f.name for f in dataclasses.fields(ExperimentConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    ref = JaxConfig()
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(ExperimentConfig(), f.name) == getattr(ref, f.name)


@pytest.mark.parametrize("files", [False, True])
def test_imagenet_load_data_matches_jax(files, tmp_path, monkeypatch):
    """Without the shards both fall back to the same synthetic (3, 32, 32)
    split; with npz and npy shards both read the same images (kept
    uint8) and split off the same validation set."""
    monkeypatch.setenv("IFT_DATA_DIR", str(tmp_path))
    if files:
        base = tmp_path / "imagenet32"
        os.makedirs(base)
        rs = np.random.RandomState(1)
        for i in (1, 2):
            np.savez(base / f"train_data_batch_{i}.npz",
                     data=rs.randint(0, 256, (9, 3072)).astype(np.uint8))
        np.save(base / "val_data.npy",
                rs.randint(0, 256, (7, 3072)).astype(np.uint8))
        kw = dict(batch_size=4, seed=3, val_split=5)
        ours, ref = timagenet.load_data(**kw), jimagenet.load_data(**kw)
        assert ours[0].data.dtype == np.uint8
    else:
        with pytest.warns(UserWarning, match="synthetic"):
            ours = timagenet.load_data(batch_size=100)
        with pytest.warns(UserWarning, match="synthetic"):
            ref = jimagenet.load_data(batch_size=100)
        assert ours[0].data.shape == (2000, 3, 32, 32)
    np.testing.assert_array_equal(ours[0].data, ref[0].data)
    assert ours[0].shuffle and ours[0].drop_last
    for a, b in zip(ours[1:], ref[1:]):
        _assert_same_batches(a, b)


def test_entry_points_default_to_the_card():
    """build_glow, Experiment and MemoryTracker put their work on "cuda"
    unless the caller names another device, and Flow.sample on its
    parameters' device (the card for a flow without any); without a card
    the default raises and nothing moves to the CPU."""
    for fn in (build_glow, Experiment, MemoryTracker):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    for kind in ("inv_conv_no_pad", "ff"):
        with pytest.raises((AssertionError, RuntimeError)):
            build_glow((1, 8, 8), step_kind=kind, num_blocks=1,
                       block_size=1, coupling_width=4)
    with pytest.raises((AssertionError, RuntimeError)):
        Flow(GaussianPrior((1, 2, 2)), []).sample(1)
    flow = Flow(None, [])
    loader = tloader.ArrayLoader(np.zeros((2, 1, 4, 4), np.float32), 2)
    with pytest.raises((AssertionError, RuntimeError)):
        Experiment(flow, loader, loader, loader, ExperimentConfig())
    with pytest.raises((AssertionError, RuntimeError)):
        MemoryTracker()


@pytest.mark.parametrize("name", [
    "8gaussians", "2spirals", "checkerboard", "rings", "moons", "swissroll",
    "circles", "sine", "1gaussian", "trimodal", "trimodal2", "smile",
    "pinwheel"])
def test_toy_densities_match_jax(name):
    """Every toy density draws JAX's samples from the same seed, and the
    loaders hold the same splits (seeds seed, seed + 1, seed + 2)."""
    ours = ttoy.sample_toy(name, 257, seed=3)
    assert ours.shape == (257, 2) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jtoy.sample_toy(name, 257, seed=3))
    mine = ttoy.load_data(name, n_train=64, n_val=33, n_test=10,
                          batch_size=16, seed=4)
    theirs = jtoy.load_data(name, n_train=64, n_val=33, n_test=10,
                            batch_size=16, seed=4)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.data, b.data)
    assert mine[0]._prefetcher is None     # fractional: the numpy path
    twin = jloader.ArrayLoader(theirs[0].data, 16, shuffle=True, seed=4,
                               native_prefetch=False)
    _assert_same_batches(mine[0], twin)
    _assert_same_batches(mine[1], theirs[1])
    with pytest.raises(ValueError, match="unknown toy density"):
        ttoy.sample_toy("no_such_density", 4)


def test_galaxy_prepare_and_load_match_jax(tmp_path, jax_native):
    """``prepare`` on a few JPEGs per split (hidden files and other names
    skipped) writes the arrays JAX's writes; ``load_data`` gives JAX's
    batches, the train split shuffled on the native prefetcher in both;
    an empty split raises."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    for split, n in (("training", 6), ("validation", 3), ("test", 3)):
        d = tmp_path / "gm" / split
        d.mkdir(parents=True)
        for i in range(n):
            arr = rng.randint(0, 255, (80, 70, 3), dtype=np.uint8)
            image.fromarray(arr).save(d / f"img{i}.jpeg")
        (d / ".hidden.jpeg").write_bytes(b"skip me")
        (d / "notes.txt").write_text("skip me")
    root = str(tmp_path / "gm")
    ours = tgalaxy.prepare(root=root, resolution=(32, 24),
                           out_path=str(tmp_path / "ours.pkl"))
    ref = jgalaxy.prepare(root=root, resolution=(32, 24),
                          out_path=str(tmp_path / "ref.pkl"))
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    mine, theirs = (tgalaxy.load_data(batch_size=2, path=ours),
                    jgalaxy.load_data(batch_size=2, path=ref))
    assert mine[0].data_shape == (3, 32, 24)
    assert mine[0]._prefetcher is not None
    for a, b in zip(mine, theirs):
        _assert_same_batches(a, b)
    assert max(b.max() for b in mine[0]) > 1.0      # raw 0..255
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no jpeg"):
        tgalaxy._read_images(str(tmp_path / "empty"))
