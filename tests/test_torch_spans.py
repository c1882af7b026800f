"""The port's spans (``utils/profiling.span``): where they open, how many
times a train step and a draw open each, their scope, and that they change
nothing of the numbers. A CPU-only ``torch.profiler`` records them here,
as it records them beside the kernels on the card."""

import collections
import copy

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import ProfilerActivity, profile

from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.utils import profiling

# the tiny Glow: 2 blocks x 2 steps of [ActNorm, InvFlowNoPad, RQ spline,
# Coupling] and one SplitPrior between the blocks; every net recomputed
LAYERS = {"ift.actnorm": 4, "ift.solve": 4, "ift.act": 4, "ift.coupling": 4,
          "ift.prior": 1}
NETS = 4 + 1


def _experiment():
    data = np.random.RandomState(19).randint(0, 256, (8, 1, 8, 8))
    flow = build_glow((1, 8, 8), num_blocks=2, block_size=2,
                      coupling_width=8,
                      generator=torch.Generator().manual_seed(19),
                      device="cpu")
    cfg = ExperimentConfig(name="spans", batch_size=8, lr=1e-3,
                           weight_clamp=0.01, save_images=False,
                           log_timing=False, plot_recon=False)
    loader = ArrayLoader(data.astype(np.float32), 8)
    exp = Experiment(flow, loader, loader, loader, cfg, device="cpu")
    batch = exp._prep_batch(next(iter(loader)))
    exp.maybe_data_init(batch)
    return exp, batch


@pytest.fixture(scope="module")
def exp_and_batch():
    return _experiment()


def _ift_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ift.")]


def _counts(events):
    return collections.Counter(e.name() for e in events)


def test_without_a_profiler_a_span_is_one_shared_null_context():
    a, b = profiling.span("ift.step"), profiling.span("ift.solve.chain")
    assert a is b and a is profiling.span(None)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("ift.step") is not a
        assert profiling.span(None) is a


def test_a_train_step_opens_each_span_as_often_as_its_layers(exp_and_batch):
    exp, batch = exp_and_batch
    exp = copy.deepcopy(exp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.train_step(batch)
    counts = _counts(_ift_events(prof))
    solves = LAYERS["ift.solve"]
    assert counts == {"ift.step": 1, "ift.step.forward": 1,
                      "ift.step.backward": 1, "ift.step.optim": 1,
                      **LAYERS,
                      # forward and backward: one build and one launch each
                      "ift.solve.build": 2 * solves,
                      "ift.solve.chain": 2 * solves,
                      # forward, and the checkpoint's recompute
                      "ift.coupling.net": 2 * NETS}
    assert set(counts) <= set(profiling.SPANS)


def test_the_recompute_opens_inside_the_backward(exp_and_batch):
    exp, batch = exp_and_batch
    exp = copy.deepcopy(exp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.train_step(batch)
    events = _ift_events(prof)

    def window(name):
        (e,) = [e for e in events if e.name() == name]
        return e.start_ns(), e.start_ns() + e.duration_ns()

    nets = [e.start_ns() for e in events if e.name() == "ift.coupling.net"]
    for name in ("ift.step.forward", "ift.step.backward"):
        a, b = window(name)
        assert sum(a <= t < b for t in nets) == NETS, name
    step_a, step_b = window("ift.step")
    assert all(step_a <= e.start_ns() <= step_b for e in events)


def test_a_draw_opens_its_spans(exp_and_batch):
    exp, _ = exp_and_batch
    gen = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.flow.sample(4, gen)
    # the sampling direction's masked conv is a conv: no build, no chain
    assert _counts(_ift_events(prof)) == {"ift.sample": 1, **LAYERS,
                                          "ift.coupling.net": NETS}


def test_no_span_is_user_scope(exp_and_batch):
    """kineto copies USER_SCOPE ranges onto the device timeline, where a
    trace reader would count them as device ops."""
    exp, batch = exp_and_batch
    exp = copy.deepcopy(exp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.train_step(batch)
        exp.flow.sample(2, torch.Generator().manual_seed(4))
    events = _ift_events(prof)
    assert events
    assert all(e.scope() == int(RecordScope.FUNCTION) for e in events)
    assert all(e.scope() != int(RecordScope.USER_SCOPE) for e in events)


def test_a_profiled_step_gives_the_same_numbers(exp_and_batch):
    exp, batch = exp_and_batch
    plain, traced = copy.deepcopy(exp), copy.deepcopy(exp)
    loss = plain.train_step(batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced_loss = traced.train_step(batch)
    assert torch.equal(loss, traced_loss)
    for (name, p), q in zip(plain.flow.named_parameters(),
                            traced.flow.parameters()):
        assert torch.equal(p, q), name
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), name
