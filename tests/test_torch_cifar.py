"""The CIFAR-10 slice against the JAX package, on the CPU: the loader's
augmentations, ``data/cifar10.py`` on pickle batches written to
``tmp_path`` and its synthetic fallback, and the four CIFAR registry
models at reduced depth and width.

Inputs come from numpy with a seed; weights cross with
``params_from_jax``. Both loaders shuffle the uint8 CIFAR data on the
native prefetcher by default (the JAX module on a library that ``make``
did not build: ``test_torch_native.py``'s ``jax_native`` fixture), and
the augmentation draws from each loader's ``RandomState`` after it; the
hook's test holds both on the numpy path.

Tolerances: the loaders and augmentations exactly; log p of the models
rtol 1e-5 (as ``test_torch_glow.py``), their gradients rel 1e-4 by norm
(as ``test_torch_baselines.py``).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.data import cifar10 as jcifar10
from inverse_flow_tpu.data import loader as jloader
from inverse_flow_tpu.experiments import registry as jregistry
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models import glow as jglow
from inverse_flow_tpu_torch import cli
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.data import cifar10 as tcifar10
from inverse_flow_tpu_torch.data import loader as tloader
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models import glow as tglow
from test_torch_baselines import _rel, _t
from test_torch_native import jax_native  # noqa: F401  (a fixture)
from test_torch_selfnorm import _grad_tree

CIFAR_NAMES = ("if_glow_cifar", "ff_glow_cifar", "selfnorm_glow_cifar",
               "conv1x1_glow_cifar")


def _batch(n=6, shape=(3, 8, 8), seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + shape).astype(
        np.float32)


def _same_batches(ours, ref, epochs=2):
    assert len(ours) == len(ref) and ours.data_shape == ref.data_shape
    for _ in range(epochs):             # a second epoch reshuffles
        a, b = [x.copy() for x in ours], [x.copy() for x in ref]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Augmentations and the loader's hook
# ---------------------------------------------------------------------------

AUGMENTS = {
    "flip": lambda m: m.random_flip_lr,
    "pad_edge": lambda m: m.pad_translate_crop(2),
    "pad_reflect": lambda m: m.pad_translate_crop(1, mode="reflect"),
    "affine": lambda m: m.affine_translate_crop(2),
    "affine_wide": lambda m: m.affine_translate_crop(3, 0.1),
    "cifar": lambda m: m.compose(m.random_flip_lr, m.affine_translate_crop(2),
                                 m.random_flip_lr),
}


@pytest.mark.parametrize("name", list(AUGMENTS))
def test_augmentations_match_jax(name):
    """Each augmentation on the same batch and the same RandomState
    gives JAX's batch exactly, and leaves the state where JAX's does."""
    x = _batch(seed=1)
    ours_rng, ref_rng = np.random.RandomState(5), np.random.RandomState(5)
    ours = AUGMENTS[name](tloader)(x.copy(), ours_rng)
    ref = AUGMENTS[name](jloader)(x.copy(), ref_rng)
    assert ours.shape == x.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert ours_rng.randint(1 << 30) == ref_rng.randint(1 << 30)


def test_affine_translate_crop_is_a_shifted_window():
    """Every output is the edge-padded input's window at a shift in
    {-1, 0, 1} per axis (f = 0.04 of the 36-wide padded image rounds to
    at most one pixel)."""
    x = _batch(n=16, seed=2)
    out = tloader.affine_translate_crop(2)(x.copy(),
                                           np.random.RandomState(0))
    padded = np.pad(x, ((0, 0), (0, 0), (2, 2), (2, 2)), mode="edge")
    for i in range(len(x)):
        assert any(np.array_equal(out[i], padded[i, :, 2 + dy:10 + dy,
                                                 2 + dx:10 + dx])
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_array_loader_augment_hook_matches_jax(shuffle, drop_last):
    """The hook runs on every batch with the loader's own RandomState,
    after the shuffle: the same seed gives JAX's batches."""
    data = _batch(n=11, seed=3)
    aug = "cifar"
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last)
    ours = tloader.ArrayLoader(data, 4, augment=AUGMENTS[aug](tloader),
                               native_prefetch=False, **kw)
    ref = jloader.ArrayLoader(data, 4, augment=AUGMENTS[aug](jloader),
                              native_prefetch=False, **kw)
    _same_batches(ours, ref)


# ---------------------------------------------------------------------------
# data/cifar10.py
# ---------------------------------------------------------------------------

def _write_cifar(root, per_batch=6, n_test=5, nested=False):
    """Five train batches and a test batch in the python-pickle format,
    under ``root/cifar-10-batches-py`` (or ``root/cifar10/...``)."""
    d = root / "cifar10" / "cifar-10-batches-py" if nested else \
        root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rs = np.random.RandomState(7)
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (per_batch, 3072))
                         .astype(np.uint8),
                         b"labels": [0] * per_batch}, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": rs.randint(0, 256, (n_test, 3072))
                     .astype(np.uint8), b"labels": [0] * n_test}, f)


@pytest.mark.parametrize("data_aug,nested", [(True, False), (False, False),
                                             (True, True)])
def test_cifar_load_data_matches_jax(data_aug, nested, tmp_path,
                                     monkeypatch, jax_native):
    """From the same pickle batches both split 40k/10k (here 24/6 at
    ``train_split=24``) and give the same train (shuffled, augmented),
    val and test batches; both look in ``$IFT_DATA_DIR`` and its
    ``cifar10/`` subdirectory."""
    _write_cifar(tmp_path, nested=nested)
    monkeypatch.setenv("IFT_DATA_DIR", str(tmp_path))
    kw = dict(data_aug=data_aug, batch_size=4, seed=2, train_split=24,
              synthetic_ok=False)
    ours, ref = tcifar10.load_data(**kw), jcifar10.load_data(**kw)
    assert ours[0].data.shape == (24, 3, 32, 32)
    assert ours[1].data.shape == (6, 3, 32, 32)
    assert ours[2].data.shape == (5, 3, 32, 32)
    assert (ours[0].augment is not None) == data_aug
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.data, b.data)
        _same_batches(a, b)


def test_cifar_synthetic_fallback_matches_jax(tmp_path, monkeypatch,
                                              jax_native):
    """Without the batches both warn and fall back to the same synthetic
    (3, 32, 32) split of 2000 / 500 / 500; ``synthetic_ok=False``
    raises."""
    monkeypatch.setenv("IFT_DATA_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="CIFAR-10 not found"):
        ours = tcifar10.load_data(batch_size=100, seed=3)
    with pytest.warns(UserWarning):
        ref = jcifar10.load_data(batch_size=100, seed=3)
    assert [len(l.data) for l in ours] == [2000, 500, 500]
    assert ours[0].data_shape == tcifar10.SHAPE == (3, 32, 32)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.data, b.data)
    _same_batches(ours[0], ref[0], epochs=1)
    assert tcifar10.load_arrays() is None
    with pytest.raises(FileNotFoundError):
        tcifar10.load_data(synthetic_ok=False)


# ---------------------------------------------------------------------------
# The four CIFAR registry models, at reduced depth and width
# ---------------------------------------------------------------------------

SIZE = (3, 32, 32)
B = 4
REDUCED = dict(block_size=2, coupling_width=16)


def _reduced(build):
    """``build`` with every registry entry's depth and width cut to
    ``REDUCED``; the other arguments are the registry's."""
    return lambda *a, **kw: build(*a, **{**kw, **REDUCED})


def _model_pair(name, monkeypatch, seed=0):
    """The registry's JAX and port models of ``name`` at reduced depth and
    width, with JAX's params (from ``seed``; every leaf moved by 0.05
    noise, so the zero-initialized coupling outputs are not zero), and a
    dequantized batch."""
    monkeypatch.setattr(jregistry, "build_glow",
                        _reduced(jglow.build_glow))
    monkeypatch.setattr(tregistry, "build_glow",
                        _reduced(tglow.build_glow))
    jflow = jregistry.get_experiment(name).build_model()
    tflow = tregistry.get_experiment(name).build_model(device="cpu")
    init = lambda k: jflow.init(k, SIZE)[0]     # noqa: E731
    # Conv1x1's init takes its QR in numpy: it cannot be traced
    eager = name.startswith("conv1x1")
    jparams = jax.device_get((init if eager else jax.jit(init))(
        jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), jparams)
    params_from_jax(tflow, jparams)
    y = (rs.randint(0, 256, (B,) + SIZE)
         + rs.uniform(0.0, 1.0, (B,) + SIZE)).astype(np.float32)
    return jflow, jparams, tflow, y


@pytest.mark.parametrize("name", CIFAR_NAMES)
def test_cifar_models_match_jax(name, monkeypatch):
    """Layer types in order, log p(x) after dequantization, and the
    gradients of every leaf of the mean -log p(x) on the path the config
    trains on (the exact path unless ``modified_grad``), against
    ``jax.grad``."""
    jflow, jparams, tflow, y = _model_pair(name, monkeypatch)
    assert [type(l).__name__ for l in tflow.layers] == [
        type(l).__name__ for l in jflow.layers]
    exact = not tregistry.get_experiment(name).config.modified_grad
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    ref = jax.jit(lambda p: jsub.forward(p, y, exact=exact)[1])(jparams[1:])
    refs = jax.jit(jax.grad(lambda p: -jnp.mean(
        jsub.forward(p, y, exact=exact)[1])))(jparams[1:])
    logp = tsub(_t(y), exact=exact)[1]
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(ref),
                               rtol=1e-5)
    (-logp.mean()).backward()
    grads = _grad_tree(tsub)
    for (path, r), a in zip(jax.tree_util.tree_leaves_with_path(refs),
                            jax.tree_util.tree_leaves(grads)):
        assert _rel(a, r) <= 1e-4, path


@pytest.mark.parametrize("name", ["if_glow_cifar", "selfnorm_glow_cifar"])
def test_cli_smoke_runs_the_cifar_names(name, tmp_path, monkeypatch, capsys):
    """``--name <cifar name> --smoke --cpu``: the miniature model of the
    family on synthetic (3, 8, 8) images, 2 epochs, the summary JSON last
    with a finite test BPD."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--name", name, "--smoke", "--cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["Epoch"] == 2 and np.isfinite(summary["Test BPD"])
