"""The port's data parallelism against the JAX package's ``shard_map``
step, on the CPU: spawned gloo groups of 2 ranks (one case of 4), each
rank a process that trains its slice of the global batch
(``tests/torch_workers.py``); the JAX side on the 8 CPU devices that
``tests/conftest.py`` forces.

Weights cross with ``params_from_jax``; batches are the JAX synthetic
loaders' arrays. Every spawn joins its group at a ``file://`` path under
``tmp_path`` and has 120 s to finish, after which it fails.

Tolerances: against JAX DP, the JAX package's own bounds for DP against
one device (``tests/test_experiment.py:161-243``): eval log p(x) rtol
1e-5, a step's loss and recon loss rtol 1e-4, GECO's weight rtol 1e-5,
parameters atol 1e-5 rtol 1e-4 (another split of the batch sums the
gradients in another order). Within the port, the averaged loss and
gradients against the mean of one-process runs on each slice rtol 1e-6
(the same float32 sums, one division); a world of one against no data
parallelism bitwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_workers as w
from inverse_flow_tpu.data import synthetic as jsynthetic
from inverse_flow_tpu.distributions import GaussianPrior as JaxGaussian
from inverse_flow_tpu.layers import ActNorm as JaxActNorm
from inverse_flow_tpu.layers import Coupling as JaxCoupling
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import InvFlowUnit as JaxInvFlowUnit
from inverse_flow_tpu.layers import SelfNormConv as JaxSelfNormConv
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch import parallel as dp
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax

B = 16
TIMEOUT = 120.0


def _spawn(fn, size, tmp_path, *args, name="pg"):
    return dp.spawn(fn, size, f"file://{tmp_path}/{name}", args=args,
                    timeout=TIMEOUT)


def _data(n_train, n_val, size=w.SIZE):
    loaders = jsynthetic.load_data(size, n_train=n_train, n_val=n_val,
                                   n_test=32, batch_size=B)
    return dict(zip(("train", "val", "test"), (l.data for l in loaders)))


def _jax_experiment(jflow, data, tmp_path, **kw):
    from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
    cfg = JaxConfig(**dict(dict(
        name="dp", epochs=1, lr=1e-3, batch_size=B, warmup_epochs=1,
        log_interval=100, sample_epochs=1000, n_samples=2,
        add_recon_grad=False, plot_recon=False, save_images=False,
        log_timing=False, data_parallel=True,
        checkpoint_path=str(tmp_path / "j.pkl"),
        metrics_path=str(tmp_path / "j.jsonl")), **kw))
    loaders = (JaxLoader(data["train"], B, native_prefetch=False),
               JaxLoader(data["val"], B, drop_last=False,
                         native_prefetch=False),
               JaxLoader(data["test"], B, drop_last=False,
                         native_prefetch=False))
    exp = JaxExperiment(jflow, *loaders, cfg)
    assert exp.mesh is not None and exp.mesh.size == 8
    return exp


def _state_from_jax(flow_name, jparams):
    return w.numpy_state(params_from_jax(w.FLOWS[flow_name](), jparams))


def _assert_params_match_jax(flow_name, state, jparams):
    flow = w.FLOWS[flow_name]()
    flow.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    ours = params_to_jax(flow)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def fused_case(tmp_path_factory):
    """JAX ``shard_map`` DP on the deterministic fused flow
    (``test_shard_map_dp_matches_single_device_fused``): data init, eval
    over a val split of 35 (the last batch of 3 divides neither mesh nor
    world), one step; and the weights before data init."""
    tmp_path = tmp_path_factory.mktemp("fused")
    data = _data(64, 35)
    jflow = JaxFlow(JaxGaussian(w.SIZE),
                    [JaxActNorm(2), JaxInvFlowUnit(2, (3, 3),
                                                   solver="fused"),
                     JaxCoupling(w.SIZE, width=8)])
    jexp = _jax_experiment(jflow, data, tmp_path)
    state = _state_from_jax("det_fused", jexp.state.params)
    x = data["train"][:B]
    jexp.maybe_data_init(x)
    logpx = jexp.eval_epoch(jexp.val_loader)
    st, loss, _ = jexp._train_step(jexp.state, jexp._prep_batch(x),
                                   jax.random.PRNGKey(42))
    return dict(data=data, state=state, x=x, logpx=logpx, loss=float(loss),
                params=jax.device_get(st.params))


@pytest.mark.parametrize("size", [2, 4])
def test_dp_matches_jax_shard_map_fused(size, fused_case, tmp_path):
    """(a) The deterministic fused flow at a world of ``size`` against JAX
    DP on 8 devices: data init on the whole batch, eval (each rank its
    slice; the partial batch whole on rank 0), one step's loss and
    weights; the replicas equal."""
    c = fused_case
    cfg = w.config(tmp_path, data_parallel=True)
    out = _spawn(w.eval_and_step, size, tmp_path, "det_fused", c["state"],
                 c["data"], cfg, c["x"])
    for r in out:
        assert r["equal"]
        np.testing.assert_allclose(r["logpx"], c["logpx"], rtol=1e-5)
        np.testing.assert_allclose(r["loss"], c["loss"], rtol=1e-4)
    assert out[0]["loss"] == out[-1]["loss"]
    _assert_params_match_jax("det_fused", out[0]["params"], c["params"])


def test_dp_selfnorm_recon_geco_matches_jax(tmp_path):
    """(b) SelfNorm with the recon term and GECO, 3 steps at a world of 2,
    against JAX DP (``test_shard_map_dp_selfnorm_recon_geco_parity``):
    loss, recon loss, GECO's weight and the weights; the replicas equal
    after every step (GECO took the averaged recon loss)."""
    data = _data(32, 16)
    kw = dict(modified_grad=True, add_recon_grad=True,
              recon_loss_weight=1.0, recon_loss_lr=1e-3, weight_clamp=0.5)
    jexp = _jax_experiment(JaxFlow(JaxGaussian(w.SIZE),
                                   [JaxSelfNormConv(2, 2, (3, 3), bias=True,
                                                    padding=1)]),
                           data, tmp_path, **kw)
    state = _state_from_jax("selfnorm", jexp.state.params)
    x = data["train"][:B]
    st = jexp.state
    for _ in range(3):
        st, loss, recon = jexp._train_step(st, jexp._prep_batch(x),
                                           jax.random.PRNGKey(7))
    cfg = w.config(tmp_path, data_parallel=True, **kw)
    out = _spawn(w.geco_steps, 2, tmp_path, "selfnorm", state, data, cfg, x,
                 3)
    for r in out:
        assert r["equal"] == [True] * 3
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(r["recon"], float(recon), rtol=1e-4)
        np.testing.assert_allclose(r["recon_weight"],
                                   float(st.recon_weight), rtol=1e-5)
    assert float(st.recon_weight) != 1.0
    _assert_params_match_jax("selfnorm", out[0]["params"],
                             jax.device_get(st.params))


def test_dp_noise_is_per_rank(tmp_path):
    """(c) Each rank draws its dequantization noise from its own
    generator (``test_shard_map_dp_per_shard_noise_semantics``): the
    averaged loss and gradients of a step at a world of 2 equal the mean
    of one-process steps on each slice with that rank's generator state;
    the ranks' generators differ, rank 0's is the one-device run's."""
    data = _data(64, 32, w.TINY)
    x = data["train"][:B]
    cfg = w.config(tmp_path, data_parallel=True)
    out = _spawn(w.noise_step, 2, tmp_path, "tiny_glow", data, cfg, x)
    assert not np.array_equal(out[0]["gen_state"], out[1]["gen_state"])
    assert out[0]["loss"] == out[1]["loss"]
    losses, grads = [], []
    for rank, r in enumerate(out):
        exp = w.experiment("tiny_glow", out[0]["state"], data,
                           cfg.replace(data_parallel=False))
        exp._data_initialized = True
        exp.generator.set_state(torch.from_numpy(r["gen_state"]))
        xb = torch.from_numpy(dp.shard_batch(x, rank, 2))
        loss, g = w.recorded_step(exp, xb)
        losses.append(loss)
        grads.append(g)
    np.testing.assert_allclose(out[0]["loss"], np.mean(losses), rtol=1e-6)
    assert losses[0] != losses[1]
    for avg, g0, g1 in zip(out[0]["grads"], *grads):
        np.testing.assert_allclose(avg, (g0 + g1) / 2, rtol=1e-6, atol=1e-7)
    # rank 0's generator is a one-device run's: seeded with cfg.seed and
    # advanced by data init on the same batch
    one = w.experiment("tiny_glow", None, data,
                       cfg.replace(data_parallel=False))
    one.maybe_data_init(x)
    assert np.array_equal(one.generator.get_state().numpy(),
                          out[0]["gen_state"])


def test_dp_trains_stochastic_glow(tmp_path):
    """(d) The tiny stochastic Glow (``_tiny_setup``) trains 2 epochs at a
    world of 2: finite, falling loss; the replicas bitwise equal after
    every step; eval finite and the same on both ranks."""
    cfg = w.config(tmp_path, data_parallel=True, epochs=2)
    out = _spawn(w.train_epochs, 2, tmp_path, 2, cfg)
    l1, l2 = out[0]["losses"]
    assert np.isfinite([l1, l2]).all() and l2 < l1
    for r in out:
        assert r["losses"] == out[0]["losses"]
        assert r["equal"] == [True] * 8
        assert r["logpx"] == out[0]["logpx"] and np.isfinite(r["logpx"])


def test_dp_world_of_one_is_the_one_device_run(tmp_path):
    """(e) In a group of one, ``data_parallel=True`` trains bit for bit as
    ``data_parallel=False``: every loss and every weight over 2 steps."""
    data = _data(64, 32, w.TINY)
    cfg = w.config(tmp_path, data_parallel=True)
    [same] = _spawn(w.one_rank_matches_one_device, 1, tmp_path, data, cfg, 2)
    assert same == [True, True]


@pytest.mark.parametrize("case", ["indivisible_batch", "jit", "no_group"])
def test_dp_refuses(case, tmp_path, monkeypatch):
    """(f) A train batch that the world does not divide raises naming B
    and W; ``data_parallel_impl="jit"`` raises naming ROADMAP's "Do not
    port" list; two visible cards and no process group raise, naming
    ``torchrun``."""
    data = _data(64, 32, w.TINY)
    cfg = w.config(tmp_path, data_parallel=True)
    if case == "indivisible_batch":
        msgs = _spawn(w.indivisible_batch, 2, tmp_path, data,
                      cfg.replace(batch_size=15))
        assert msgs == ["data parallelism: the train batch of 15 does not "
                        "split over a world of 2 ranks (B=15, W=2)"] * 2
        with pytest.raises(ValueError, match=r"B=15, W=2"):
            dp.shard_batch(data["train"][:15], 0, 2)
    elif case == "jit":
        with pytest.raises(NotImplementedError, match="Do not port"):
            w.experiment("tiny_glow", None, data,
                         cfg.replace(data_parallel_impl="jit"))
        w.experiment("tiny_glow", None, data, cfg.replace(
            data_parallel=False, data_parallel_impl="jit"))
    else:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(RuntimeError,
                           match=r"torchrun --nproc_per_node=N"):
            w.experiment("tiny_glow", None, data, cfg)
        w.experiment("tiny_glow", None, data,
                     cfg.replace(data_parallel=False))


def test_dp_run_writes_once_and_resumes(tmp_path):
    """(g) ``run()`` at a world of 2 for 1 epoch: rank 0 alone writes the
    metrics and the checkpoint (the other rank waits for it); a fresh
    Experiment on each rank ``load``s it and holds the trained weights and
    optimizer state, equal across the ranks."""
    data = _data(64, 32, w.TINY)
    cfg = w.config(tmp_path, data_parallel=True)
    out = _spawn(w.run_and_resume, 2, tmp_path, data, cfg)
    for r in out:
        assert r["trained_equal"] and r["resumed_same"] and r["resumed_equal"]
        assert r["step"] == 4
        assert r["summary"] == out[0]["summary"]
    assert sorted(f for f in os.listdir(tmp_path)
                  if not f.startswith("pg")) == ["ckpt.pt", "m.jsonl"]
    with open(tmp_path / "m.jsonl") as f:
        names = [json.loads(line)["name"] for line in f]
    assert names.count("Train Avg Loss") == 1
    assert names.count("Note") == 2      # the save, once


@pytest.mark.parametrize("name", ["if_multiGPU_imagenet32",
                                  "if_imagenet_multi_gpu"])
def test_cli_runs_the_dp_names_under_torchrun(name, tmp_path):
    """The CLI under ``torchrun``'s environment at a world of 2 (gloo on
    the CPU): both ranks train the smoke run of each data-parallel name,
    rank 0 alone prints the summary and writes the metrics and the
    checkpoint."""
    out = _spawn(w.cli_under_torchrun, 2, tmp_path, name, str(tmp_path))
    assert [r["rc"] for r in out] == [0, 0]
    assert [r["world"] for r in out] == [(0, 2), (1, 2)]
    summary = json.loads(out[0]["out"].strip().splitlines()[-1])
    assert summary["Epoch"] == 2.0 and np.isfinite(summary["Test LogPx"])
    assert out[1]["out"] == ""
    files = sorted(f for f in os.listdir(tmp_path) if not f.startswith("pg"))
    assert len(files) == 2 and files[0].endswith("_checkpoint.pt") \
        and files[1].endswith("_metrics.jsonl")


def test_rank_seed_and_shard_batch():
    """Rank 0 keeps the seed, the other ranks get distinct seeds; the
    shards of a batch are contiguous and cover it in rank order."""
    seeds = [dp.rank_seed(7, r) for r in range(4)]
    assert seeds[0] == 7 and len(set(seeds)) == 4
    assert seeds == [dp.rank_seed(7, r) for r in range(4)]
    x = np.arange(12)
    assert np.array_equal(np.concatenate(
        [dp.shard_batch(x, r, 3) for r in range(3)]), x)
    assert dp.world() == (0, 1)
    assert dp.replicas_equal([torch.ones(3)])
    t = torch.arange(4.0)
    assert dp.all_reduce_mean_([t])[0] is t and t.tolist() == [0, 1, 2, 3]


def test_data_parallel_without_a_group_is_one_device(tmp_path):
    """With no process group and at most one card, ``data_parallel=True``
    is the one-device run (JAX builds no mesh on one device)."""
    data = _data(64, 32, w.TINY)
    cfg = w.config(tmp_path, data_parallel=True)
    exp = w.experiment("tiny_glow", None, data, cfg)
    assert (exp.rank, exp.world_size, exp.distributed) == (0, 1, False)
    ref = w.experiment("tiny_glow", None, data,
                       cfg.replace(data_parallel=False))
    x = data["train"][:B]
    for e in (exp, ref):
        e.maybe_data_init(x)
    assert torch.equal(exp.train_step(torch.from_numpy(x)),
                       ref.train_step(torch.from_numpy(x)))
