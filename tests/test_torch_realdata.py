"""The real-data slice against the JAX package, on the CPU: the embedded
digits and patches loaders, ``Experiment.run()`` of a reduced
``real_digits_glow`` against the JAX harness's ``run()``, its sampling
direction through the SLR inverse, and a resume from a checkpoint.

Tolerances: the loaders exactly; ``run()``'s losses and BPDs rel 2e-3, the
bound of ``test_torch_train.py``'s trajectory (float32 round-off through
the solves, grown by 6 Adam steps at lr 1e-3); the samples before the
final floor rtol 1e-4 by norm, as ``test_torch_sample.py``; the resumed
epoch bit-equal to the run that did not stop (the same CPU ops on the same
state).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.data import digits as jdigits
from inverse_flow_tpu.data import loader as jloader
from inverse_flow_tpu.data import patches as jpatches
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.data import digits as tdigits
from inverse_flow_tpu_torch.data import patches as tpatches
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment

from test_torch_native import jax_native  # noqa: F401  (a fixture)
from test_torch_sample import _jax_draws

DIGITS = (1, 8, 8)
MODEL_KW = dict(step_kind="inv_flow_unit", num_blocks=2, block_size=2,
                coupling_width=16, activation="SLR")


def _batches(loader):
    return [b.copy() for b in loader]


@pytest.mark.parametrize("ours,ref,shape,sizes", [
    (tdigits, jdigits, (1, 8, 8), (1437, 180, 180)),
    (tpatches, jpatches, (3, 16, 16), (1664, 208, 208))])
def test_loaders_match_jax(ours, ref, shape, sizes, jax_native):
    """The same arrays and the same batches as the JAX loaders: train
    shuffled by the same seed, on the native prefetcher as both loaders
    take it by default and on the numpy path, val and test in order with
    their last partial batch."""
    for a, b in zip(ours.load_arrays(), ref.load_arrays()):
        np.testing.assert_array_equal(a, b)
    mine, theirs = ours.load_data(batch_size=100, seed=3), \
        ref.load_data(batch_size=100, seed=3)
    assert tuple(len(l.data) for l in mine) == sizes
    assert mine[0].data_shape == shape and ours.SHAPE == shape
    assert mine[0].shuffle and mine[0].drop_last
    np.testing.assert_array_equal(mine[0].data, theirs[0].data)
    assert mine[0]._prefetcher is not None
    numpy_path = (ArrayLoader(mine[0].data, 100, shuffle=True, seed=3,
                              native_prefetch=False),
                  jloader.ArrayLoader(theirs[0].data, 100, shuffle=True,
                                      seed=3, native_prefetch=False))
    for loader, other in ((mine[0], theirs[0]), numpy_path) + tuple(
            zip(mine[1:], theirs[1:])):
        a, b = _batches(loader), _batches(other)
        assert len(a) == len(b) == len(loader)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert sum(len(b) for b in mine[1]) == sizes[1]      # no batch dropped


# ---------------------------------------------------------------------------
# run() of the reduced real_digits_glow
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """The reduced real_digits_glow (L=2 x K=2, width 16) in JAX with its
    init from seed 0, and pre-dequantized digits: 300 train, 100 val,
    100 test."""
    jflow = jax_build_glow(DIGITS, **MODEL_KW)
    jparams = jax.device_get(jax.jit(
        lambda key: jflow.init(key, DIGITS)[0])(jax.random.PRNGKey(0)))
    train, test = tdigits.load_arrays()
    rs = np.random.RandomState(31)
    data = [a + rs.uniform(0, 1, a.shape).astype(np.float32)
            for a in (train[:300], train[1437:1537], test[:100])]
    return jflow, jparams, data


def _cfg(cls, tmp_path, tag, **kw):
    return cls(**dict(
        dict(name="IF Glow RealDigits", lr=1e-3, batch_size=100, epochs=2,
             warmup_epochs=2, modified_grad=True, add_recon_grad=False,
             recon_loss_weight=0.0, scheduler_name="None", eval_train=False,
             eval_epochs=1, log_timing=False, save_images=False,
             plot_recon=False, n_samples=4,
             metrics_path=str(tmp_path / f"{tag}.jsonl"),
             checkpoint_path=str(tmp_path / f"{tag}.ckpt")), **kw))


def _logged(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["name"], r["value"]) for r in recs]


def test_run_matches_jax(tmp_path, reduced, monkeypatch):
    """Two epochs of ``run()`` in both harnesses from the same weights on
    the same batches (the flows without their Dequantization), each with
    its data init on the first batch: the same logged names in the same
    order, and every loss and BPD at rel 2e-3."""
    jfull, jparams, (train, val, test) = reduced
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    # JAX's data init under jit: its eager pass takes many seconds
    monkeypatch.setattr(jflow, "data_init", jax.jit(jflow.data_init))
    jexp = JaxExperiment(
        jflow, *(jloader.ArrayLoader(d, 100, shuffle=i == 0, seed=0,
                                     native_prefetch=False)
                 for i, d in enumerate((train, val, test))),
        _cfg(JaxConfig, tmp_path, "jax"))
    jexp.state = jexp.state._replace(params=jax.tree_util.tree_map(
        jnp.asarray, list(jparams[1:])))
    jsummary = jexp.run()

    tfull = build_glow(DIGITS, **MODEL_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jparams[1:])
    texp = Experiment(tflow, *(ArrayLoader(d, 100, shuffle=i == 0, seed=0)
                               for i, d in enumerate((train, val, test))),
                      _cfg(ExperimentConfig, tmp_path, "torch"),
                      device="cpu")
    summary = texp.run()

    ours, ref = _logged(tmp_path / "torch.jsonl"), \
        _logged(tmp_path / "jax.jsonl")
    assert [n for n, _ in ours] == [n for n, _ in ref]
    names = [n for n, _ in ours]
    assert names.count("Train Avg Loss") == 2 and "Test BPD" in names
    for (name, a), (_, b) in zip(ours, ref):
        if name != "Note":
            np.testing.assert_allclose(a, b, rtol=2e-3, err_msg=name)
    assert summary["Epoch"] == jsummary["Epoch"] == 2
    for k in ("Best Val BPD", "Test BPD"):
        np.testing.assert_allclose(summary[k], jsummary[k], rtol=2e-3)


def test_sample_through_slr_matches_jax(reduced):
    """``Flow.sample`` of the reduced model on JAX's draws, every
    SmoothLeakyRelu inverted by the Newton loop: the output before the
    final floor against JAX's."""
    jfull, jparams, (train, _, _) = reduced
    jsub = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    jp = list(jax.device_get(jax.jit(jsub.data_init)(
        jparams[1:], jnp.asarray(train[:100]))))
    tfull = build_glow(DIGITS, **MODEL_KW, device="cpu")
    tsub = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tsub, jp)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jax.jit(lambda p, r: jsub.sample(p, r, 16))(jp, rng))
    ours = tsub.sample(16, noise=_jax_draws(jsub, rng, 16)).numpy()
    assert np.isfinite(ours).all() and np.ptp(ref) > 50
    assert np.linalg.norm(ours - ref) <= 1e-4 * np.linalg.norm(ref)


def test_resume_continues_the_run(tmp_path):
    """Save after epoch 2, load into a fresh Experiment with the generator
    state copied over and the train loader advanced by the 2 epochs it
    served (its shuffle runs on the native prefetcher's thread, whose
    state cannot be copied): epoch 3 is bit-equal to that of the run that
    did not stop, and data init does not run again."""
    spec = tregistry.get_experiment("real_digits_glow")
    train, test = tdigits.load_arrays()
    data = (train[:200], train[1437:1487], test[:50])

    def make(epochs, tag):
        flow = build_glow(DIGITS, **MODEL_KW, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        cfg = spec.config.replace(
            epochs=epochs, batch_size=100, log_timing=False,
            save_images=False, plot_recon=False, sample_epochs=10_000,
            n_samples=2, metrics_path=str(tmp_path / f"{tag}.jsonl"),
            checkpoint_path=str(tmp_path / f"{tag}.pt"))
        return Experiment(flow, *(ArrayLoader(d, 100, shuffle=i == 0,
                                              seed=0)
                                  for i, d in enumerate(data)), cfg,
                          device="cpu")

    whole = make(3, "whole")
    whole.run()
    first = make(2, "first")
    first.run()
    first.save()
    resumed = make(3, "first")
    resumed.load()
    resumed.generator.set_state(first.generator.get_state())
    for _ in range(2):
        for _ in resumed.train_loader:
            pass
    resumed.flow.data_init = None                 # must not run again
    assert resumed.step == first.step and resumed.summary["Epoch"] == 2
    resumed.run()

    def losses(tag):
        return [v for n, v in _logged(tmp_path / f"{tag}.jsonl")
                if n == "Train Avg Loss"]
    assert len(losses("whole")) == 3 and losses("first")[:2] == \
        losses("whole")[:2]
    assert losses("first")[2] == losses("whole")[2]
    for p, q in zip(resumed.flow.parameters(), whole.flow.parameters()):
        assert torch.equal(p, q)
