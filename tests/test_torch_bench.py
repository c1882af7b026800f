"""The port's bench entry point (``inverse_flow_tpu_torch/bench.py``)
against the JAX package's ``bench.py``, on the CPU.

The bench's step against the JAX bench's own ``one_step`` on a reduced
``glow_mnist`` (L=2, K=2, width 16) after dequantization, the weights
carried over with ``params_from_jax``; the row's fields from a CPU run,
with no device number filled in; the step's FLOP count, the same
whichever chain runs; the error line without a card; the configuration
names.

Tolerances: the loss rel 1e-5 (the forward alone, float32); the update
of one Adam(1e-5) step, the weights after it less those before, within
0.1 x lr of JAX's update in every entry. Adam's first step moves each
weight by lr * g / (|g| + eps): about lr wherever the gradient is not
0, so an update that is missing, of the wrong sign or of the wrong size
is off by about lr; float32 round-off of the weights (of order 1) is
about 1e-7 of one.
"""

import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as jbench
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu_torch import bench
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data import synthetic
from inverse_flow_tpu_torch.experiments import bench_configs
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.ops import fused_chain

SMALL = dict(num_blocks=2, block_size=2, coupling_width=16)
# the row's and the FLOP count's tests, which hold no values to JAX
TINY = dict(num_blocks=1, block_size=2, coupling_width=8)
B = 8


def test_step_matches_the_jax_bench_one_step():
    """``train_step_fn`` against ``bench._make_train_scan``'s ``one_step``
    from the JAX bench's data init on ``smooth_images(8, size)``."""
    jfull, size, _ = jbench._glow_mnist(**SMALL)
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    # the JAX bench's own init and data init, under jit (eager, they take
    # many seconds)
    jflow.init = jax.jit(jflow.init, static_argnums=1)
    jflow.data_init = jax.jit(jflow.data_init)
    _, (one_step, params, opt_state, rng) = jbench._make_train_scan(
        jflow, size, B)
    new_params, _, jloss = jax.jit(one_step)(params, opt_state, rng)

    tfull, tsize, _ = bench_configs.build("glow_mnist", "cpu", **SMALL)
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jax.device_get(params))
    x = torch.from_numpy(synthetic.smooth_images(B, tsize))
    loss = bench.train_step_fn(tflow, x, None)()

    assert tsize == size
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    final = jax.device_get(new_params)
    back = params_to_jax(tflow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(final))

    def update(after):
        return np.concatenate([
            (np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(
                jax.tree_util.tree_leaves(after),
                jax.tree_util.tree_leaves(jax.device_get(params)))])

    ours, ref = update(back), update(final)
    # most weights take a step of about lr: the comparison is not of zeros
    assert (np.abs(ref) > 0.5 * bench.LR).mean() > 0.5
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.1 * bench.LR)


def test_cpu_row_has_every_field_and_no_device_number():
    row = bench.bench_config("glow_mnist", device="cpu", rounds=2, steps=1,
                             draws=2, **TINY)
    assert "error" not in row
    assert row["config"] == "glow_mnist" and row["batch_size"] == 100
    assert row["device"] == "cpu" and row["power_limit_w"] is None
    assert row["methodology"].startswith("host clock")
    assert len(row["train_step_ms_turns"]) == 2 and row["turns"] == [2, 1]
    assert min(row["train_step_ms_turns"]) <= row["train_step_ms"] \
        <= max(row["train_step_ms_turns"])
    for key in ("train_step_ms", "sample_latency_ms_per_image",
                "samples_per_sec_per_chip", "train_step_gflops",
                "chain_gflops", "achieved_tflops", "setup_s"):
        assert row[key] > 0, key
    assert row["sample_finite"] is True
    # not measured on the CPU: no number under a device metric's name
    for key in ("device_busy_ms", "idle_share", "launch_calls",
                "mfu_pct_of_bf16_peak", "roofline_compute_bound_ms",
                "peak_tflops_assumed", "peak_memory_gb"):
        assert row[key] is None, key
    # a CPU tensor takes the plain chain: no kernel launch; the step's 2
    # solves each call the chain forward and backward
    assert row["chain_launches_by_variant"] == dict.fromkeys(
        fused_chain.VARIANTS, 0)
    assert row["chain_calls_per_step"] == 2 * 2
    assert set(row) >= {"loss", "flops_methodology"}


def _zeros_chain(xb, t_all, g_all, dirs, kcw, pad_cw=0, variant=None):
    """A chain launch's output shape, all zeros, and no matmul."""
    return xb.new_zeros((len(dirs),) + tuple(xb.shape))


@pytest.mark.parametrize("name", ["glow_mnist", "imagenet32"])
def test_step_flops_do_not_depend_on_the_chain(name):
    """The plain chain's matmuls are not counted on top of ``chain_work``:
    the count with the plain chain equals the count with a stub that
    makes no product, and both are FlopCounterMode's count of the rest of
    the step plus 2 x ``chain_work`` x batch for each launch."""
    gen = torch.Generator().manual_seed(0)
    flow, shape, _ = bench_configs.build(name, "cpu", gen, **TINY)
    x = torch.from_numpy(synthetic.smooth_images(4, shape))
    flow.data_init(x, gen)
    step = bench.train_step_fn(flow, x, gen)

    plain = bench.step_flops(step)
    with FlopCounterMode(display=False) as seen_plain:
        step()
    with mock.patch.object(fused_chain, "chain_phases", _zeros_chain):
        stubbed = bench.step_flops(step)
    work = []

    def recording(*args, **kwargs):
        work.append(2 * fused_chain.chain_work(args)[0] * args[0].shape[1])
        return _zeros_chain(*args, **kwargs)

    with mock.patch.object(fused_chain, "chain_phases", recording), \
            FlopCounterMode(display=False) as rest:
        step()

    assert plain == stubbed
    assert plain[0] == rest.get_total_flops() + sum(work)
    assert plain[1] == sum(work) > 0 and plain[2] == len(work) == 4
    # the counter does see the plain chain's matmuls, which step_flops
    # leaves out
    assert seen_plain.get_total_flops() > rest.get_total_flops()


@pytest.mark.parametrize("argv", [[], ["--config", "imagenet32"], ["--all"]])
def test_main_without_a_card_exits_1_with_the_error(argv, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 1
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert all("CUDA" in line["error"] for line in lines)
    if not argv:
        assert len(lines) == 1 and {k: lines[0][k] for k in (
            "metric", "value", "unit", "vs_baseline")} == {
            "metric": "glow_mnist_train_step", "value": None,
            "unit": "ms/batch", "vs_baseline": None}
    else:
        names = ["imagenet32"] if argv[0] == "--config" else list(
            bench.CONFIGS)
        assert [l["config"] for l in lines] == names
        assert all(l["train_step_ms"] is None for l in lines)


def test_config_choices_are_the_bench_configs():
    ap = bench.parser()
    choices = next(a.choices for a in ap._actions if a.dest == "config")
    assert list(choices) == list(bench_configs.CONFIGS) \
        == list(jbench.CONFIGS)
