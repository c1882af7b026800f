"""The port's harness against the JAX package, on the CPU: the
``SmoothLeakyRelu`` inverse, ``Flow.forward_verbose``, ``eval_mc_samples``,
the reconstruction plots of ``train_epoch``, the config fields that act or
raise, the registry and the CLI.

Inputs and noise come from numpy or from JAX's own draws, injected into
both packages; weights cross with ``params_from_jax``. On a CPU tensor
``slr_inverse`` runs its plain loop and the chain its plain version.

Tolerances: the SLR inverse rtol 1e-5 (100 Newton steps to a fixed point,
each an ulp apart in the two packages' exp and log1p; atol 1e-6 where x
crosses 0), its round trip 1e-5 * max(1, |y|); per-layer ldj and log p(x)
rtol 1e-5 (as ``test_torch_glow.py``); the eval log p(x) over 3 draws rtol
1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.experiments import registry as jregistry
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import conv1x1 as jconv1x1
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch import cli
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import activations as tact
from inverse_flow_tpu_torch.train.config import (ExperimentConfig,
                                                 check_ported)
from inverse_flow_tpu_torch.train.experiment import Experiment

DIGITS = (1, 8, 8)
# the reduced real_digits_glow: L=2 x K=2 InvFlowUnit, width 16, SLR
MODEL_KW = dict(step_kind="inv_flow_unit", num_blocks=2, block_size=2,
                coupling_width=16, activation="SLR")


def _slr_inputs():
    rs = np.random.RandomState(21)
    y = rs.uniform(-40.0, 40.0, (4, 3, 8, 8)).astype(np.float32)
    y.reshape(-1)[:6] = [40.0, -40.0, 0.0, 1e-3, -1e-3, -20.5]
    return y


@pytest.mark.parametrize("alpha", [0.3, 0.005])
def test_slr_inverse_matches_jax(alpha):
    """The 100-step Newton inverse against JAX's, at |y| <= 40; alpha
    0.005 takes the f' floor of 1e-2 (f' = alpha + (1-alpha)*sigmoid(x)
    never falls below alpha, so at the models' 0.3 it does not bind).
    Then the round trip both ways."""
    y = _slr_inputs()
    jlayer, tlayer = jl.SmoothLeakyRelu(alpha=alpha), \
        tl.SmoothLeakyRelu(alpha=alpha)
    ref = np.asarray(jax.jit(jlayer.inverse)({}, jnp.asarray(y)))
    x = tlayer.inverse(torch.from_numpy(y))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-5, atol=1e-6)
    if alpha == 0.005:
        assert (tact.slr_prime(x, alpha) < tact.FPRIME_FLOOR).any()
    back = tlayer(x)[0].numpy()
    assert np.all(np.abs(back - y) <= 1e-5 * np.maximum(1.0, np.abs(y)))
    xs = torch.from_numpy(y / 4)
    trip = tlayer.inverse(tlayer(xs)[0])
    torch.testing.assert_close(trip, xs, rtol=1e-5, atol=1e-5)


def test_slr_inverse_reference_is_the_cpu_path():
    """On a CPU tensor the layer's inverse is the plain loop, and no
    kernel launch is counted."""
    y = torch.from_numpy(_slr_inputs())
    before = tact.slr_inverse.launches
    out = tl.SmoothLeakyRelu(alpha=0.3).inverse(y)
    assert torch.equal(out, tact.slr_inverse_reference(y, 0.3))
    assert torch.equal(out, tact.slr_inverse(y, 0.3))
    assert tact.slr_inverse.launches == before
    assert tact.NEWTON_ITERS == 100


# ---------------------------------------------------------------------------
# The reduced real_digits_glow in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def digits_pair():
    """JAX's init and data init of the reduced model on one batch,
    carried into the port: (jflow, jparams, tflow, data)."""
    jflow = jax_build_glow(DIGITS, **MODEL_KW)
    jparams = jax.jit(lambda key: jflow.init(key, DIGITS)[0])(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(22)
    data = rs.randint(0, 17, (24,) + DIGITS).astype(np.float32) * 15
    x = data[:16] + rs.uniform(0, 1, (16,) + DIGITS).astype(np.float32)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jparams = [jparams[0]] + list(jax.jit(jsub.data_init)(
        jparams[1:], jnp.asarray(x)))
    jparams = jax.device_get(jparams)
    tflow = build_glow(DIGITS, **MODEL_KW, device="cpu")
    params_from_jax(tflow, jparams)
    return jflow, jparams, tflow, data


def test_forward_verbose_matches_jax(digits_pair):
    """Keys ``f"{i:02d}_{type}"`` and each layer's mean ldj, z and
    log p(x) against JAX's ``forward_verbose`` (the flows without their
    Dequantization, on pre-dequantized data)."""
    jflow, jparams, tflow, data = digits_pair
    x = data[:8] + np.random.RandomState(23).uniform(
        0, 1, (8,) + DIGITS).astype(np.float32)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    zj, lpj, per_j = jax.jit(jsub.forward_verbose)(jparams[1:],
                                                   jnp.asarray(x))
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    with torch.no_grad():
        z, lp, per = tsub.forward_verbose(torch.from_numpy(x))
    assert list(per) == list(per_j)
    assert list(per)[:4] == ["00_Normalization", "01_Normalization",
                             "02_LogitTransform", "03_Squeeze"]
    for k in per:
        np.testing.assert_allclose(float(per[k]), float(per_j[k]),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lpj), rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), tsub(torch.from_numpy(x))[1]
                               .detach().numpy(), rtol=0, atol=0)


def _uniform_draws(jflow, key, n, draws):
    """The dequantization noise of JAX's ``eval_logpx_sum`` on one batch
    key: one uniform draw per split of the key, from the Dequantization's
    layer rng."""
    out = []
    for r in jax.random.split(key, draws):
        rng = jflow._layer_rngs(r)[0]
        out.append(np.array(jflow.layers[0].distribution.sample(rng, n)[0]))
    return out


def test_eval_mc_samples_matches_jax(tmp_path, digits_pair, monkeypatch):
    """``eval_mc_samples=3``: the mean over three dequantization draws per
    example, summed over the batch, against the JAX harness's
    ``eval_epoch`` with the same draws injected into the port's
    Dequantization (two batches, the last one partial)."""
    jflow, jparams, tflow, data = digits_pair
    kw = dict(eval_mc_samples=3, metrics_path=str(tmp_path / "m.jsonl"),
              save_images=False)
    jexp = JaxExperiment(jflow, *(JaxLoader(data, 16, drop_last=False,
                                            native_prefetch=False)
                                  for _ in range(3)), JaxConfig(**kw))
    jexp.state = jexp.state._replace(params=jparams)
    jexp._data_initialized = True
    keys = []
    next_rng = jexp._next_rng

    def recorded():
        keys.append(next_rng())
        return keys[-1]
    monkeypatch.setattr(jexp, "_next_rng", recorded)
    ref = jexp.eval_epoch(jexp.val_loader)
    assert len(keys) == 2

    queue = []
    for key, n in zip(keys, (16, 8)):
        queue += _uniform_draws(jflow, key, n, 3)
    texp = Experiment(tflow, *(ArrayLoader(data, 16, drop_last=False)
                               for _ in range(3)), ExperimentConfig(**kw),
                      device="cpu")
    texp._data_initialized = True
    deq = tflow.layers[0]
    monkeypatch.setattr(deq, "forward", lambda x, generator=None: (
        type(deq).forward(deq, x, noise=torch.from_numpy(queue.pop(0)))))
    ours = texp.eval_epoch(texp.val_loader)
    assert not queue
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    one = _uniform_draws(jflow, keys[0], 16, 1)[0]
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    with torch.no_grad():
        single = float(tsub.cheap_log_prob(torch.from_numpy(data[:16] + one))
                       .mean())
    assert abs(single - ours) > 1e-3       # the draws were averaged


def _small_experiment(tmp_path, **kw):
    """One step of K=1 per level, 2 batches of 8, 1 epoch."""
    data = np.random.RandomState(24).randint(0, 17, (16,) + DIGITS) * 15.0
    flow = build_glow(DIGITS, **dict(MODEL_KW, block_size=1), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cfg = ExperimentConfig(name="small", batch_size=8, epochs=1,
                           log_timing=False, n_samples=2,
                           sample_dir=str(tmp_path / "s"),
                           metrics_path=str(tmp_path / "m.jsonl"),
                           checkpoint_path=str(tmp_path / "c.pt"), **kw)
    loader = ArrayLoader(data.astype(np.float32), 8)
    return Experiment(flow, loader, loader, loader, cfg, device="cpu")


@pytest.mark.parametrize("plot", [True, False])
def test_train_epoch_plots_recon(tmp_path, plot):
    """With ``plot_recon`` train_epoch reconstructs its last batch (through
    the SLR inverse) and writes x, its reconstruction and their difference
    under the epoch's number; without it, nothing."""
    exp = _small_experiment(tmp_path, plot_recon=plot)
    recon = []
    orig = exp.plot_recon
    exp.plot_recon = lambda x, e: recon.append((x, e)) or orig(x, e)
    exp.train_epoch(3)
    names = ("3_x.png", "3_xrecon.png", "3_recon_diff.png")
    if plot:
        assert len(recon) == 1 and recon[0][1] == 3
        np.testing.assert_array_equal(recon[0][0],
                                      list(exp.train_loader)[-1])
        for name in names:
            assert (tmp_path / "s" / name).read_bytes().startswith(
                b"\x89PNG")
    else:
        assert not recon and not (tmp_path / "s").exists()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_config_fields_act_or_raise(tmp_path):
    """``verbose`` logs each layer's mean ldj; ``profile_dir`` writes a
    trace of epoch 1; ``save_images`` with a multiple of ``vis_epochs``
    within the run writes the filter heatmaps (``Flow.plot_filters``);
    ``data_parallel`` with ``data_parallel_impl="jit"`` raises (ROADMAP's
    "Do not port" list)."""
    exp = _small_experiment(tmp_path, verbose=True, plot_recon=False,
                            save_images=False,
                            profile_dir=str(tmp_path / "prof"))
    exp.run()
    names = [r["name"] for r in _records(tmp_path / "m.jsonl")]
    assert names.count("ldj/05_RepeatedBlock") == 1
    assert names.count("ldj/00_Dequantization") == 1
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0

    exp = _small_experiment(tmp_path, vis_epochs=1)
    exp.run()
    assert exp.summary["Epoch"] == 1
    filters = sorted(os.listdir(tmp_path / "s" / "filters"))
    assert filters and all(f.startswith("e0001_") for f in filters)
    check_ported(exp.cfg.replace(vis_epochs=2))
    check_ported(exp.cfg.replace(save_images=False))
    with pytest.raises(NotImplementedError, match="Do not port"):
        _small_experiment(tmp_path, data_parallel=True,
                          data_parallel_impl="jit")


# ---------------------------------------------------------------------------
# Registry and CLI
# ---------------------------------------------------------------------------

SIZES = {"if_glow_mnist": (1, 28, 28), "ff_glow_mnist": (1, 28, 28),
         "if_glow_imagenet32": (3, 32, 32), "real_digits_glow": DIGITS,
         "real_patches_glow": (3, 16, 16),
         **dict.fromkeys(("exact_fc_mnist", "selfnorm_fc_mnist",
                          "if_cnn_mnist", "if_exact_cnn_mnist",
                          "exact_cnn_mnist", "selfnorm_cnn_mnist",
                          "emerging_cnn_mnist", "exponential_cnn_mnist",
                          "selfnorm_glow_mnist",
                          "geco_selfnorm_glow_mnist", "conv1x1_glow_mnist",
                          "if_conv1x1_glow_mnist"), (1, 28, 28)),
         "selfnorm_glow_imagenet": (3, 32, 32),
         "conv1x1_glow_imagenet": (3, 32, 32), "real_digits_fc": DIGITS,
         **dict.fromkeys(("if_glow_cifar", "ff_glow_cifar",
                          "selfnorm_glow_cifar", "conv1x1_glow_cifar"),
                         (3, 32, 32)),
         "if_multiGPU_imagenet32": (3, 32, 32)}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_registry_entry_matches_jax(name, monkeypatch):
    """The port's entry: the JAX entry's config, and a model whose
    parameters carry the JAX tree's names and shapes (JAX's by
    ``eval_shape``, or eagerly where the init cannot be traced; Conv1x1's
    init, a QR in numpy, is traced as ``jnp.linalg.qr`` for it: the
    shapes are the same)."""
    monkeypatch.setattr(jconv1x1, "_orthogonal_init", lambda rng, n: (
        jnp.linalg.qr(jax.random.normal(rng, (n, n)))[0]))
    ours, ref = tregistry.get_experiment(name), jregistry.get_experiment(name)
    assert ours.config.to_dict() == ref.config.to_dict()
    jflow = ref.build_model()

    def init(key):
        return jflow.init(key, SIZES[name])[0]

    # ConvExp's init sizes u by int(jnp.prod(...)), which a trace cannot
    # give, so that model is initialised eagerly
    shapes = (init(jax.random.PRNGKey(0)) if name == "exponential_cnn_mnist"
              else jax.eval_shape(init, jax.random.PRNGKey(0)))
    flow = ours.build_model(device="cpu",
                            generator=torch.Generator().manual_seed(0))
    back = params_to_jax(flow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(shapes))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape


def test_unported_names_raise():
    """Every JAX name is registered in the port (``NOT_PORTED`` is empty),
    the two data-parallel ones with JAX's config field by field; an
    unknown name raises KeyError."""
    assert tregistry.NOT_PORTED == {}
    assert set(jregistry.EXPERIMENTS) == set(tregistry.EXPERIMENTS)
    assert set(SIZES) | set(tregistry.TIMESCALING) | {
        "if_imagenet_multi_gpu"} == set(tregistry.EXPERIMENTS)
    for name in ("if_multiGPU_imagenet32", "if_imagenet_multi_gpu"):
        ours = tregistry.get_experiment(name).config
        ref = jregistry.get_experiment(name).config
        assert ours.data_parallel and ours.data_parallel_impl == "shard_map"
        for f in dataclasses.fields(ref):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        check_ported(ours)
    with pytest.raises(KeyError):
        tregistry.get_experiment("no_such_experiment")


def test_cli_list_and_smoke(tmp_path, monkeypatch, capsys):
    """``--list`` names the port's experiments; ``--smoke --cpu`` trains
    the miniature model for 2 epochs and prints the summary JSON last;
    without ``--cpu`` the run is on the card and raises without one."""
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()[2:]
    assert listed == sorted(set(tregistry.EXPERIMENTS) | {"memory_speed"})
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--name", "real_digits_glow", "--smoke", "--cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["Epoch"] == 2 and np.isfinite(summary["Test BPD"])
    assert (tmp_path / "IF_Glow_RealDigits_checkpoint.pt").exists()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(["--name", "real_digits_glow", "--smoke"])
