"""The Fig. 4 timescaling sweeps, ``memory_speed``, their CLI dispatch and
the filter plots against the JAX package, on the CPU.

Both packages write their records into the working directory, so each
test runs in its own ``tmp_path`` (and JAX in a subdirectory of it).
Tolerances: log p(x) rtol 1e-5, gradients 1e-5 by norm; the filter PNGs
byte for byte (the same float32 weights).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.distributions import GaussianPrior as JaxPrior
from inverse_flow_tpu.experiments import registry as jregistry
from inverse_flow_tpu.experiments.memory_speed import \
    run_memory_speed as jax_memory_speed
from inverse_flow_tpu.experiments.timescaling import \
    run_timescaling as jax_timescaling
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import SelfNormConv as JaxSelfNormConv
from inverse_flow_tpu.layers.inv_flow import InvFlowNoPad as JaxInvFlowNoPad
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.ops import solver_policy as jsp
from inverse_flow_tpu.utils import imaging as jimaging
from inverse_flow_tpu_torch import cli
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.experiments.memory_speed import run_memory_speed
from inverse_flow_tpu_torch.experiments.timescaling import (
    loss_and_grads, run_timescaling, timescale_model)
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import inv_conv as tic
from inverse_flow_tpu_torch.ops import solver_policy as tsp
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.utils import imaging as timaging

NAMES = ("if_timescaling", "if_jacobi_timescaling", "if_auto_timescaling",
         "snf_timescaling", "if_tall_timescaling",
         "if_jacobi_tall_timescaling", "if_auto_tall_timescaling")
FIELDS = {"size", "shape", "batch", "ms_mean", "ms_std", "ms_best"}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _norm_rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def test_registry_has_the_seven_sweeps():
    """The port registers the JAX sweep names with the JAX configs; their
    model is built per size, so ``build_model`` gives None."""
    assert set(tregistry.TIMESCALING) == set(NAMES)
    for name in NAMES:
        ours = tregistry.get_experiment(name)
        assert ours.config.to_dict() == \
            jregistry.get_experiment(name).config.to_dict()
        assert ours.build_model(device="cpu") is None


@pytest.mark.parametrize("name", NAMES)
def test_smoke_sweep_writes_the_jax_records(name, tmp_path, monkeypatch):
    """``run_timescaling(name, smoke=True, device='cpu')`` appends one
    record per size to ``./<name>_timescale.jsonl`` with exactly the
    fields, sizes, shapes and batch of the JAX sweep's."""
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_timescaling(name, smoke=True) == 0
    ref = _records(f"{name}_timescale.jsonl")
    monkeypatch.chdir(tmp_path)
    assert run_timescaling(name, smoke=True, device="cpu") == 0
    ours = _records(f"{name}_timescale.jsonl")
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == FIELDS
        assert (a["size"], a["shape"], a["batch"]) == \
            (b["size"], b["shape"], b["batch"])
        assert 0 < a["ms_best"] <= a["ms_mean"] and a["ms_std"] >= 0


def _jax_model(name, shape, n_layers=2):
    """The JAX sweep's model, as ``run_timescaling`` builds it inline."""
    if name.startswith("snf"):
        layers = [JaxSelfNormConv(1, 1, (3, 3), bias=False, padding=1)
                  for _ in range(n_layers)]
    elif "jacobi" in name:
        layers = [JaxInvFlowNoPad(1, (2, 2), solver="jacobi",
                                  jacobi_iters=12) for _ in range(n_layers)]
    elif "auto" in name:
        layers = [JaxInvFlowNoPad(1, (2, 2), solver="auto")
                  for _ in range(n_layers)]
    else:
        layers = [JaxInvFlowNoPad(1, (2, 2)) for _ in range(n_layers)]
    return JaxFlow(JaxPrior(shape), layers)


@pytest.mark.parametrize("name", NAMES)
def test_sweep_model_matches_jax(name, monkeypatch):
    """Each arm's 2-layer model at one size (H = 128 tall, inside the JAX
    window, so that ``'auto'`` routes Jacobi in both; s = 8 square): the
    loss and its gradients against JAX, weights carried across (JAX's
    init plus 0.05 x randn, so that each solve moves x)."""
    for const in ("JACOBI_LONG_MIN", "JACOBI_LONG_MAX", "JACOBI_THIN_MAX",
                  "JACOBI_KERNEL_MAX", "JACOBI_AUTO_TOL", "JACOBI_TOL_MIN"):
        monkeypatch.setattr(tsp, const, getattr(jsp, const))
    shape = (1, 128, 1) if "tall" in name else (1, 8, 8)
    jflow = _jax_model(name, shape)
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(
            np.float32),
        jflow.init(jax.random.PRNGKey(0), shape)[0])
    x = rs.randn(8, *shape).astype(np.float32)
    loss_ref, grads = jax.value_and_grad(
        lambda p: -jnp.mean(jflow.forward(p, jnp.asarray(x))[1]))(params)

    tflow = timescale_model(name, shape, device="cpu")
    params_from_jax(tflow, params)
    tic.reset_jacobi_counts()
    loss, ours = loss_and_grads(tflow, torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    ref = {f"layers.{i}.{'.'.join(str(k.key) for k in path)}": leaf
           for i, tree in enumerate(grads)
           for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    names = [n for n, _ in tflow.named_parameters()]
    assert sorted(names) == sorted(ref)
    for pname, g in zip(names, ours):
        assert _norm_rel(g.numpy(), ref[pname]) <= 1e-5, pname
    routed = "auto" in name and "tall" in name
    assert tic.inv_conv_solve_jacobi_guarded.syncs == (4 if routed else 0)


def test_memory_speed_smoke(tmp_path, monkeypatch):
    """``run_memory_speed(smoke=True)`` on the CPU writes the JAX record's
    keys (no device memory on a CPU in either package) with a finite
    loss."""
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_memory_speed(smoke=True) == 0
    ref = _records("memory_speed.jsonl")[-1]
    monkeypatch.chdir(tmp_path)
    assert run_memory_speed(smoke=True, device="cpu") == 0
    (ours,) = _records("memory_speed.jsonl")
    assert set(ours) == set(ref)
    for key in ("step_kind", "data_size", "batch_size"):
        assert ours[key] == ref[key]
    assert np.isfinite(ours["loss"]) and ours["train_ms_per_batch"] > 0
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=0.05)


def test_cli_dispatches_sweeps_and_memory_speed(tmp_path, monkeypatch,
                                                capsys):
    """``--list`` shows ``memory_speed`` and the sweeps; ``--smoke --cpu``
    runs a sweep and ``memory_speed`` (ignoring run flags with a
    warning, as JAX); without ``--cpu`` they ask for the card."""
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()[2:]
    assert "memory_speed" in listed and set(NAMES) <= set(listed)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--name", "if_auto_tall_timescaling", "--smoke",
                     "--cpu", "--epochs", "3"]) == 0
    assert "ignoring --epochs" in capsys.readouterr().err
    assert len(_records("if_auto_tall_timescaling_timescale.jsonl")) == 2
    assert cli.main(["--name", "memory_speed", "--smoke", "--cpu"]) == 0
    assert len(_records("memory_speed.jsonl")) == 1
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(["--name", "if_timescaling", "--smoke"])


# ---------------------------------------------------------------------------
# Filter plots
# ---------------------------------------------------------------------------

GLOW_SIZE = (1, 8, 8)
GLOW_KW = dict(step_kind="inv_flow_unit", num_blocks=2, block_size=2,
               coupling_width=8, activation="SLR")


@pytest.fixture(scope="module")
def small_glow():
    jflow = jax_build_glow(GLOW_SIZE, **GLOW_KW)
    params = jax.device_get(jflow.init(jax.random.PRNGKey(0),
                                       GLOW_SIZE)[0])
    tflow = build_glow(GLOW_SIZE, **GLOW_KW, device="cpu")
    params_from_jax(tflow, params)
    return jflow, params, tflow


def test_filter_heatmap_grid_matches_jax():
    w = np.random.RandomState(1).randn(6, 4, 3, 2).astype(np.float32)
    np.testing.assert_array_equal(timaging.filter_heatmap_grid(w),
                                  jimaging.filter_heatmap_grid(w))


def test_plot_filters_matches_jax(small_glow, tmp_path):
    """The same file names as JAX's ``plot_filters`` (each stacked step's
    kernel its own file), byte for byte."""
    jflow, params, tflow = small_glow
    ref = jflow.plot_filters(params, str(tmp_path / "jax"), prefix="e0007")
    ours = tflow.plot_filters(str(tmp_path / "ours"), prefix="e0007")
    names = sorted(os.path.basename(p) for p in ours)
    assert names == sorted(os.path.basename(p) for p in ref)
    assert any("_k1" in n for n in names)
    for n in names:
        with open(tmp_path / "jax" / n, "rb") as a, \
                open(tmp_path / "ours" / n, "rb") as b:
            assert a.read() == b.read(), n


def test_run_writes_filter_plots(small_glow, tmp_path):
    """``run()`` with ``save_images`` and ``vis_epochs`` 1 no longer raises:
    each epoch writes the filters under ``<sample_dir>/filters``, named as
    JAX's ``plot_filters`` names them with the epoch's prefix."""
    jflow, params, tflow = small_glow
    data = np.random.RandomState(2).randint(0, 256, (16,) + GLOW_SIZE)
    loader = ArrayLoader(data.astype(np.float32), 8)
    cfg = ExperimentConfig(name="filters", batch_size=8, epochs=2,
                           vis_epochs=1, save_images=True, log_timing=False,
                           n_samples=2, sample_dir=str(tmp_path / "s"),
                           metrics_path=str(tmp_path / "m.jsonl"),
                           checkpoint_path=str(tmp_path / "c.pt"))
    exp = Experiment(copy.deepcopy(tflow), loader, loader, loader, cfg,
                     device="cpu")
    assert exp.run()["Epoch"] == 2
    written = sorted(os.listdir(tmp_path / "s" / "filters"))
    ref = jflow.plot_filters(params, str(tmp_path / "jax"), prefix="e0001")
    per_epoch = sorted(os.path.basename(p) for p in ref)
    assert written == sorted(per_epoch + [n.replace("e0001", "e0002")
                                          for n in per_epoch])
