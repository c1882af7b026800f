"""The check sees what it is there to see, at sizes a test run holds:
the control (the reference one precision lower) fails the committed
limits, and a run with the timed path broken underneath comes out
``correct: false``: a step that leaves the state unchanged, a step on half
of its batch, a sample with an image altered where it is produced, a
sample with half of its images left out."""

import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, harness  # noqa: E402
from benchmark.tests.small import CONTROL, SMALL  # noqa: E402

SPEC = harness.load_json(ROOT, "BENCHMARK.json")


def run(cell_name, sizes=SMALL):
    cell = harness.Cell(SPEC, cell_name, 2 ** 31 + 5, 0.3, 0, device="cpu",
                        overrides=sizes[cell_name])
    out, err = io.StringIO(), io.StringIO()
    harness.run(cell, 0.0, out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_fails_the_limits_and_the_program_passes(cell):
    (line,) = control.main(["--workload", cell, "--seeds", "2147483659"],
                           device="cpu", overrides=CONTROL[cell])
    limits = harness.load_json(ROOT, "benchmark", "limits", cell + ".json")
    assert all(v <= limits[k] for k, v in line["program"].items())
    assert any(v > limits[k] for k, v in line["control"].items())
    if "half_batch" in line:
        assert any(v > limits[k] for k, v in line["half_batch"].items())


def test_state_left_unchanged_is_caught(monkeypatch):
    from inverse_flow_tpu_torch.train import experiment

    monkeypatch.setattr(experiment, "apply_grads", lambda *a, **k: None)
    result = run("glow_mnist.train_b24576")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("cell", ["glow_mnist.train_b24576"])
def test_half_the_batch_is_caught(monkeypatch, cell):
    from inverse_flow_tpu_torch.train.experiment import Experiment

    step = Experiment.train_step
    monkeypatch.setattr(Experiment, "train_step",
                        lambda self, x: step(self, x[:x.shape[0] // 2]))
    assert run(cell)["correct"] is False


def test_an_altered_image_is_caught(monkeypatch):
    from inverse_flow_tpu_torch.layers.sequential import Flow

    sample = Flow.sample

    def altered(self, n, generator=None, noise=None, exact=False):
        x = sample(self, n, generator, noise, exact).clone()
        x[n // 2] += 1.0
        return x

    monkeypatch.setattr(Flow, "sample", altered)
    result = run("glow_mnist.sample_b32768")
    assert result["correct"] is False
    assert result["checks"]["image_off_share"]["value"] == 1.0


def test_half_the_images_left_out_is_caught(monkeypatch):
    from inverse_flow_tpu_torch.layers.sequential import Flow

    sample = Flow.sample
    monkeypatch.setattr(
        Flow, "sample", lambda self, n, generator=None, noise=None,
        exact=False: sample(self, n, generator, noise, exact)[:n // 2])
    assert run("glow_mnist.sample_b32768")["correct"] is False
