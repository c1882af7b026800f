"""The port's training path against the JAX package, on the CPU.

Inputs and noise come from numpy with a seed; weights are carried over
with ``params_from_jax`` and read back with ``params_to_jax``. On a CPU
tensor the chain solve runs its plain version in both directions, and the
JAX solves run as the JAX tests run them (Pallas in interpret mode).

Tolerances:
  * layer gradients: norm-relative 1e-4, float32 round-off of a backward
    through a solve and sums over a few hundred elements;
  * learning rates and one optimizer update: 1e-6, float32 against
    float64 schedule arithmetic;
  * trajectory: the first loss rel 1e-5 (the forward alone), every loss
    of 10 Adam steps rel 2e-3 (the bound of the JAX package's
    ``test_trajectory_flagship_topology``), final weights atol 1e-4 but
    for a spline-knot flip (see the test).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.train import optim as joptim
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu.train.metrics import MetricsLogger as JaxLogger
from inverse_flow_tpu.train.stats import StatsRecorder as JaxStats
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import fused_chain
from inverse_flow_tpu_torch.train import optim
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.train.memory import MemoryTracker
from inverse_flow_tpu_torch.train.metrics import MetricsLogger
from inverse_flow_tpu_torch.train.stats import StatsRecorder

from test_torch_layers import CASES, _input, _load, _randomize, _step_pair

GLOW_KW = dict(num_blocks=2, block_size=2, coupling_width=16)


@pytest.fixture(scope="module")
def jax_glow():
    """The flagship topology at reduced width in JAX, and its params from
    seed 1 (initialised under jit: the eager init takes many seconds)."""
    jflow = jax_build_glow((1, 28, 28), **GLOW_KW)
    jparams = jax.device_get(jax.jit(
        lambda key: jflow.init(key, (1, 28, 28))[0])(jax.random.PRNGKey(1)))
    return jflow, jparams


def _norm_rel(ours, ref):
    return np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30)


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# Gradients of every slice layer
# ---------------------------------------------------------------------------

def _remat_repeated_pair():
    jax_step, torch_step = _step_pair((4, 6, 6))
    return (jl.RepeatedBlock(jax_step, 2, remat=True),
            tl.RepeatedBlock(torch_step, 2, remat=True), (4, 6, 6))


GRAD_CASES = dict(CASES)
GRAD_CASES["coupling_remat"] = lambda: (
    jl.Coupling((4, 6, 6), width=16, remat_net=True),
    tl.Coupling((4, 6, 6), width=16, remat_net=True), (4, 6, 6))
GRAD_CASES["repeated_block_remat"] = _remat_repeated_pair


def _torch_grads(tlayer, x, r, s):
    xt = torch.from_numpy(x).requires_grad_()
    z, ldj = tlayer(xt)
    ((z * torch.from_numpy(r)).sum()
     + (ldj * torch.from_numpy(s)).sum()).backward()
    grads = {n: p.grad.numpy().copy() for n, p in tlayer.named_parameters()}
    tlayer.zero_grad(set_to_none=True)
    return xt.grad.numpy(), grads


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_layer_grads_match_jax(name):
    """d/d(params, x) of sum(z*r) + sum(ldj*s), against jax.grad."""
    jlayer, tlayer, shape = GRAD_CASES[name]()
    jparams = _randomize(jlayer.init(jax.random.PRNGKey(0), shape)[0], 1)
    _load(tlayer, jparams)
    x = _input(name, shape)
    zj, _ = jax.eval_shape(jlayer.forward, jparams, jnp.asarray(x))
    rs = np.random.RandomState(11)
    r = rs.randn(*zj.shape).astype(np.float32)
    s = rs.randn(x.shape[0]).astype(np.float32)

    def scalar(p, a):
        z, ldj = jlayer.forward(p, a)
        return jnp.sum(z * r) + jnp.sum(ldj * s)

    gp, gx = jax.jit(jax.grad(scalar, argnums=(0, 1)))(jparams,
                                                       jnp.asarray(x))
    dx, grads = _torch_grads(tlayer, x, r, s)
    assert _norm_rel(dx, np.asarray(gx)) <= 1e-4
    for n, g in grads.items():
        assert _norm_rel(g, _leaf(gp, n)) <= 1e-4, n


@pytest.mark.parametrize("name", ["coupling", "repeated_block"])
def test_remat_gives_identical_grads(name):
    """Checkpointing changes memory, never values."""
    remat = {"coupling": "coupling_remat",
             "repeated_block": "repeated_block_remat"}[name]
    jlayer, plain, shape = GRAD_CASES[name]()
    _, rematted, _ = GRAD_CASES[remat]()
    jparams = _randomize(jlayer.init(jax.random.PRNGKey(0), shape)[0], 1)
    _load(plain, jparams)
    _load(rematted, jparams)
    x = _input(name, shape)
    r = np.random.RandomState(12).randn(*shape).astype(np.float32)
    r = np.broadcast_to(r, x.shape).copy()
    s = np.ones(x.shape[0], np.float32)
    dx_a, g_a = _torch_grads(plain, x, r, s)
    dx_b, g_b = _torch_grads(rematted, x, r, s)
    np.testing.assert_array_equal(dx_a, dx_b)
    for n in g_a:
        np.testing.assert_array_equal(g_a[n], g_b[n], err_msg=n)


# ---------------------------------------------------------------------------
# Optimizer, schedule, clamp
# ---------------------------------------------------------------------------

SCHEDULERS = ["None", "StepLR", "MultiStepLR", "ExponentialLR",
              "CosineAnnealingLR", "CosineAnnealingWarmRestarts"]
SCHED_KW = dict(lr=1e-3, warmup_epochs=2, gamma=0.9, step_size=3,
                milestones=(1, 4), cosine_t_max=5, cosine_t0=4,
                cosine_eta_min=1e-5)


@pytest.mark.parametrize("name", SCHEDULERS)
def test_lr_schedule_matches_jax(name):
    """lr(step) at steps 0..30, and the rate the optimizer runs at when
    the LambdaLR is stepped once per batch."""
    kw = dict(SCHED_KW, scheduler_name=name)
    ours = optim.make_lr_schedule(ExperimentConfig(**kw), 3)
    ref = joptim.make_lr_schedule(JaxConfig(**kw), 3)
    p = torch.zeros(1, requires_grad=True)
    opt, sched = optim.make_optimizer(
        ExperimentConfig(**kw, optimizer_name="SGD"), [p], 3)
    for step in range(31):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], ours(step),
                                   rtol=1e-12)
        opt.step()
        sched.step()


OPTIMIZERS = {
    "adam_clamp": dict(optimizer_name="Adam", weight_clamp=0.3),
    "adamax": dict(optimizer_name="Adamax"),
    "sgd": dict(optimizer_name="SGD", sgd_momentum=0.9,
                sgd_weight_decay=1e-2),
    "adam_clip": dict(optimizer_name="Adam", grad_clip_norm=0.5),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """Three updates on the same gradients (global norm about 10), with
    warmup and ExponentialLR; a parameter with no gradient still moves
    under Adam's moments, as every optax leaf does."""
    kw = dict(lr=1e-2, warmup_epochs=1, scheduler_name="ExponentialLR",
              gamma=0.9, **OPTIMIZERS[name])
    rs = np.random.RandomState(13)
    params = [(0.5 * rs.randn(4, 3)).astype(np.float32),
              (0.5 * rs.randn(5)).astype(np.float32)]
    grads = [[(3 * rs.randn(*p.shape)).astype(np.float32) for p in params]
             for _ in range(3)]
    grads[2][1] = np.zeros_like(params[1])      # no gradient at step 3

    cfg = JaxConfig(**kw)
    tx, _ = joptim.make_optimizer(cfg, steps_per_epoch=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt, sched = optim.make_optimizer(ExperimentConfig(**kw), tp, 2)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        if cfg.weight_clamp:
            jp = [jnp.clip(p, -cfg.weight_clamp, cfg.weight_clamp)
                  for p in jp]
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        if step == 2:
            tp[1].grad = None
        optim.apply_grads(ExperimentConfig(**kw), opt, sched, tp)
        for ours, ref in zip(tp, jp):
            np.testing.assert_allclose(ours.detach().numpy(),
                                       np.asarray(ref), rtol=0, atol=1e-6)
    if cfg.weight_clamp:
        assert (max(p.detach().abs().max() for p in tp)
                == np.float32(cfg.weight_clamp))


def test_unknown_optimizer_and_scheduler_raise():
    p = [torch.zeros(1, requires_grad=True)]
    with pytest.raises(ValueError):
        optim.make_optimizer(ExperimentConfig(optimizer_name="Lion"), p, 1)
    with pytest.raises(ValueError):
        optim.make_lr_schedule(ExperimentConfig(scheduler_name="Cyclic"), 1)


# ---------------------------------------------------------------------------
# The flagship topology's training trajectory
# ---------------------------------------------------------------------------

def _traj_config(tmp_path, cls):
    return cls(name="traj", batch_size=8, lr=2e-4, optimizer_name="Adam",
               scheduler_name="ExponentialLR", gamma=0.96170,
               weight_clamp=0.01, log_timing=False, save_images=False,
               plot_recon=False, metrics_path=str(tmp_path / "m.jsonl"),
               checkpoint_path=str(tmp_path / "c.pkl"))


def test_trajectory_matches_jax(tmp_path, jax_glow):
    """``build_glow((1,28,28))`` at L=2, K=2, width 16 after
    dequantization (pre-dequantized data, as in test_torch_glow.py): JAX's
    data init, then 2 epochs x 5 batches of B=8 through JAX's
    ``Experiment._train_step`` and the port's ``train_step`` from the same
    weights."""
    rs = np.random.RandomState(14)
    data = (rs.randint(0, 256, (40, 1, 28, 28))
            + rs.uniform(0.0, 1.0, (40, 1, 28, 28))).astype(np.float32)
    jfull, jparams = jax_glow
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    jexp = JaxExperiment(
        jflow, *(JaxLoader(data, 8, native_prefetch=False)
                 for _ in range(3)), _traj_config(tmp_path, JaxConfig))
    # JAX's maybe_data_init, under jit (its eager pass takes many seconds)
    params = jax.jit(jflow.data_init)(jparams[1:], jnp.asarray(data[:8]))
    jexp.state = jexp.state._replace(params=params,
                                     opt_state=jexp.tx.init(params))
    jexp._data_initialized = True

    tfull = build_glow((1, 28, 28), **GLOW_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jax.device_get(params))
    texp = Experiment(tflow, *(ArrayLoader(data, 8) for _ in range(3)),
                      _traj_config(tmp_path, ExperimentConfig), device="cpu")
    texp._data_initialized = True

    ours, ref = [], []
    for _ in range(2):
        for b in range(5):
            x = data[b * 8:(b + 1) * 8]
            jexp.state, loss, _ = jexp._train_step(
                jexp.state, jnp.asarray(x), jexp._next_rng())
            ref.append(float(loss))
            ours.append(float(texp.train_step(torch.from_numpy(x))))
    ours, ref = np.array(ours), np.array(ref)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)

    # Final weights within atol 1e-4. An input that lies on a spline knot
    # within float32 round-off gives one package a gradient of ~1e-8 where
    # the other has exactly 0 (seen here: 4.7e-8 at step 2), and Adam
    # turns any nonzero gradient into a step of about lr. So at most 0.1%
    # of the entries may exceed 1e-4, each by no more than the summed
    # learning rate of the 10 steps.
    lr_sum = sum(optim.make_lr_schedule(texp.cfg, 5)(k) for k in range(10))
    final = jax.device_get(jexp.state.params)
    back = params_to_jax(tflow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(final))
    diffs = np.concatenate([
        np.abs(a - np.asarray(b)).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(back),
            jax.tree_util.tree_leaves(final))])
    assert (diffs > 1e-4).mean() <= 1e-3
    assert diffs.max() <= lr_sum
    assert max(np.abs(a).max() for a in jax.tree_util.tree_leaves(back)) \
        <= np.float32(0.01)


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------

def _small_experiment(tmp_path, **kw):
    data = np.random.RandomState(15).randint(0, 256, (24, 1, 8, 8))
    flow = build_glow((1, 8, 8), num_blocks=1, block_size=2,
                      coupling_width=8,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    cfg = ExperimentConfig(name="small", batch_size=8, lr=1e-3,
                           weight_clamp=0.01, log_interval=1,
                           timing_interval=1, timing_window=2,
                           sample_dir=str(tmp_path / "s"),
                           metrics_path=str(tmp_path / "m.jsonl"), **kw)
    loader = ArrayLoader(data.astype(np.float32), 8)
    return Experiment(flow, loader, loader, loader, cfg, device="cpu")


def test_train_epoch_is_a_loop_of_train_steps(tmp_path):
    """train_epoch = data init + train_step per batch; it returns the mean
    loss, logs every step's loss and the windowed step time, clamps every
    weight, and launches no kernel on the CPU."""
    exp = _small_experiment(tmp_path)
    twin = copy.deepcopy(exp)
    before = fused_chain.chain_phases.launches
    mean = exp.train_epoch(1)
    assert fused_chain.chain_phases.launches == before

    opt_before = twin.optimizer
    batches = list(twin.train_loader)
    twin.maybe_data_init(batches[0])
    assert twin.optimizer is not opt_before and not twin.optimizer.state
    ref = [float(twin.train_step(twin._prep_batch(x))) for x in batches]
    np.testing.assert_allclose(mean, np.mean(ref), rtol=1e-6)

    with open(tmp_path / "m.jsonl") as f:
        recs = [json.loads(line) for line in f]
    logged = [r["value"] for r in recs if r["name"] == "Train Batch Loss"]
    assert [r["step"] for r in recs if r["name"] == "Train Batch Loss"] \
        == [1, 2, 3]
    np.testing.assert_allclose(logged, ref, rtol=1e-6)
    times = [r["value"] for r in recs
             if r["name"] == "summary/Batch Time Mean"]
    assert len(times) == 1 and times[0] > 0
    for p, q in zip(exp.flow.parameters(), twin.flow.parameters()):
        assert p.abs().max() <= 0.01
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)


def test_recon_loss_layers_and_wandb_raise(tmp_path):
    """wandb logging is not ported and raises. (The recon term is ported:
    ``tests/test_torch_selfnorm.py`` holds it to JAX.)"""
    with pytest.raises(NotImplementedError):
        MetricsLogger(str(tmp_path / "w.jsonl"), use_wandb=True)


# ---------------------------------------------------------------------------
# Copies of the JAX harness's helpers, and the bridge back
# ---------------------------------------------------------------------------

def test_stats_and_metrics_match_jax(tmp_path):
    rs = np.random.RandomState(16)
    chunks = [rs.randn(n) for n in (5, 1, 7)]
    ours, ref = StatsRecorder(), JaxStats()
    for c in chunks:
        ours.update(c)
        ref.update(c)
        assert ours.nobservations == ref.nobservations
        np.testing.assert_allclose([ours.mean, ours.std],
                                   [ref.mean, ref.std], rtol=1e-12)

    def records(cls, path):
        logger = cls(str(path), verbose=False)
        logger.log("loss", np.float32(1.5), step=3)
        logger.summary("Batch Time Mean", 2.0)
        logger.log("Note", "text")
        logger.close()
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"}
                    for line in f]

    assert (records(MetricsLogger, tmp_path / "a.jsonl")
            == records(JaxLogger, tmp_path / "b.jsonl"))


def test_memory_tracker_without_a_card():
    tracker = MemoryTracker("cpu")
    assert not tracker.available
    with pytest.raises(RuntimeError):
        tracker.snapshot()


def test_params_round_trip_through_jax_tree(jax_glow):
    _, jparams = jax_glow
    tflow = build_glow((1, 28, 28), **GLOW_KW, device="cpu")
    params_from_jax(tflow, jparams)
    back = params_to_jax(tflow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    before = [p.detach().clone() for p in tflow.parameters()]
    params_from_jax(tflow, back)
    for p, q in zip(tflow.parameters(), before):
        assert torch.equal(p, q)

