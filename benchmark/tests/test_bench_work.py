"""The yardstick's counts against hand counts and against PyTorch's own
FLOP counter over the plain reference, at small shapes."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import work  # noqa: E402
from benchmark.reference import glow as ref  # noqa: E402


def config(name, **model):
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      name + ".json")))
    cfg["model"].update(model)
    return cfg


def test_hand_counts():
    # conv3x3 2->3, conv1x1 3->4, conv3x3 4->4 on 2x2: 4 * (54 + 12 + 144)
    assert work.net_macs(4, 2, 2, 3) == 840
    # 3x3 image, 2 channels: 27 in-image non-centre tap positions x 4
    # channel pairs, and the centre's one lower pair at 9 pixels
    assert work.masked_taps(2, 3, 3) == 117
    w = work.model_work(config("glow_mnist", num_blocks=1, block_size=1,
                               coupling_width=3), 2, "train")
    # one level (4, 14, 14): one net, forward + input and weight grads
    assert w["flops"]["float32"] - w["solve_flops"] == \
        2 * 3 * 2 * work.net_macs(4, 14, 14, 3)
    taps = work.masked_taps(4, 14, 14)
    assert w["solve_flops"] == 2 * 3 * 2 * taps
    act = 4 * 2 * 4 * 14 * 14
    assert w["solves"] == [(2 * 3 * 2 * taps, 2 * act * 2 + 3 * 4 * 16 * 9)]


@pytest.mark.parametrize("c,h,w", [(2, 3, 3), (4, 5, 4), (3, 4, 4)])
def test_masked_taps_are_the_operators_off_diagonal_entries(c, h, w):
    t = ref.dense_operator(ref.masked_kernel(torch.ones(c, c, 3, 3)), c, h, w)
    off = int((t != 0).sum()) - c * h * w
    assert work.masked_taps(c, h, w) == off


# the Glow families' other step: the 4-order unit, SLR, bf16 nets
UNIT = dict(step_kind="inv_flow_unit", activation="SLR",
            coupling_dtype="bfloat16")


@pytest.mark.parametrize("variant,dtype", [({}, "float32"),
                                           (UNIT, "bfloat16")])
def test_net_flops_match_flop_counter_over_the_reference(variant, dtype):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = config("glow_mnist", num_blocks=2, block_size=2, coupling_width=8,
                 **variant)
    shape = tuple(cfg["data_shape"])
    gen = torch.Generator().manual_seed(0)
    weights = ref.make_weights(cfg["model"], shape, gen, "cpu")
    model = ref.Reference(cfg, weights)
    x = torch.floor(torch.rand((2,) + shape, generator=gen) * 256)
    noise = torch.rand(x.shape, generator=gen)
    model.data_init(x, noise)
    counter = FlopCounterMode(display=False)
    with counter:
        model.loss_and_grads(x, noise, 2)
    counts = counter.get_flop_counts()["Global"]
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    w = work.model_work(cfg, 2, "train")
    assert w["flops"][dtype] - (w["solve_flops"] if dtype == "float32"
                                else 0) == conv
