"""The chain kernel's dispatch between its CUDA kernels, on the CPU.

``chain_variant(rcw, kcw)`` picks the cluster kernel wherever a CTA's
slices of T and G fit in shared memory, the wide cluster kernel for wider
blocks. Every solve shape of the repo's three configurations must go to
the cluster kernel: the test drives each model's chain-reaching path on
the CPU at reduced depth and coupling width (the solve shapes depend only
on the activation's (C, H, W)) and records every ``chain_phases`` call.
This file imports no JAX and decides nothing about a card at import time.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops.inv_conv import apply_mask


def _recorded(run):
    """Runs ``run()`` with every ``chain_phases`` call recorded as (B,
    RCW, KCW) and answered by the plain version."""
    seen = []

    def record(xb, t_all, g_all, dirs, kcw, pad_cw=0, variant=None):
        seen.append((xb.shape[1], xb.shape[2], kcw))
        return tfc.chain_phases_reference(xb, t_all, g_all, dirs, kcw,
                                          pad_cw)

    with mock.patch.object(tfc, "chain_phases", record):
        run()
    return seen


def _scored(size, b, **kw):
    """Forward and backward of -log p(x) through a reduced model: one
    step per block, coupling width 8."""
    def run():
        gen = torch.Generator().manual_seed(0)
        flow = build_glow(size, block_size=1, coupling_width=8,
                          generator=gen, device="cpu", **kw)
        body = Flow(flow.base_distribution, flow.layers[1:])
        x = torch.rand((b,) + size, generator=gen) * 255
        (-body(x)[1]).mean().backward()
    return run


def _sampled(b):
    """``Flow.sample`` of a reduced ff_glow_mnist: FincFlow's level-2
    inverse, the expanded groups-4 kernel."""
    def run():
        gen = torch.Generator().manual_seed(0)
        flow = build_glow((1, 28, 28), step_kind="ff", num_blocks=2,
                          block_size=1, coupling_width=8, generator=gen,
                          device="cpu")
        with torch.no_grad():
            flow.sample(b, gen)
    return run


CONFIGS = {
    "if_glow_mnist": lambda b: _scored((1, 28, 28), b, num_blocks=2,
                                       step_kind="inv_conv_no_pad"),
    "imagenet32": lambda b: _scored((3, 32, 32), b, num_blocks=3,
                                    step_kind="inv_flow_unit",
                                    activation="SLR"),
    "ff_glow_mnist": _sampled,
}
# (RCW, KCW) of each configuration's solves: the flagship's and ff's
# (4, 14, 14) and (8, 7, 7); imagenet32's three levels, R=2
SHAPES = {
    "if_glow_mnist": {(392, 112), (336, 112)},
    "imagenet32": {(384, 384)},
    "ff_glow_mnist": {(392, 112), (336, 112)},
}


@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_model_shape_goes_to_the_cluster_kernel(name, b):
    seen = _recorded(CONFIGS[name](b))
    assert seen and {s[0] for s in seen} == {b}
    assert {s[1:] for s in seen} == SHAPES[name]
    assert {tfc.chain_variant(rcw, kcw) for _, rcw, kcw in seen} == {
        "cluster"}


@pytest.mark.parametrize("rcw,kcw,smem", [
    (392, 112, 154896), (336, 112, 123152), (384, 384, 209936),
    (64, 32, 26128), (10, 10, 18320)])
def test_cluster_smem_bytes(rcw, kcw, smem):
    """The mbarrier, T's and G's slices of ceil(RCW/8) rows rounded up to
    a multiple of 4 (strides 16 past a multiple of 32 floats), 2 x 8 input rows and 8 carry rows
    (padded to 4 floats), 2 x 8 rows of the CTA's outputs, 4096 partial
    sums."""
    assert tfc.cluster_smem_bytes(rcw, kcw) == smem
    assert tfc.chain_variant(rcw, kcw) == "cluster"


@pytest.mark.parametrize("rcw,kcw", [(512, 512), (520, 8), (2048, 112)])
def test_wide_shapes_go_to_the_streaming_kernel(rcw, kcw):
    """Past 227 KB of shared memory (512 x 512: 332 KB), or past 64
    columns a CTA (RCW > 512): the wide cluster kernel, which took these
    over from the streaming kernel (now only ever forced)."""
    assert tfc.chain_variant(rcw, kcw) == "cluster_wide"


@pytest.mark.parametrize("rcw,kcw", [(2052, 112), (64, 0), (64, 65)])
def test_chain_variant_rejects_shapes_no_kernel_takes(rcw, kcw):
    with pytest.raises(ValueError):
        tfc.chain_variant(rcw, kcw)


def _args(chw, orders, b):
    rs = np.random.RandomState(3)
    c = chw[0]
    x = torch.from_numpy(rs.randn(b, *chw).astype(np.float32))
    ws = tuple(apply_mask(torch.from_numpy(
        (0.1 / np.sqrt(c) * rs.randn(c, c, 3, 3)).astype(np.float32)))
        for _ in orders)
    return tfc.chain_inputs(x, ws, orders)


@pytest.mark.parametrize("variant", [None, "cluster", "cluster_wide",
                                     "streaming"])
def test_chain_phases_cpu_takes_the_plain_version(variant):
    """On a CPU tensor either variant is the plain version, bit for bit,
    and counts no launch."""
    args = _args((8, 7, 7), ("TL", "BR"), 3)
    before = (tfc.chain_phases.launches,
              dict(tfc.chain_phases.launches_by_variant))
    y = tfc.chain_phases(*args, variant=variant)
    assert torch.equal(y, tfc.chain_phases_reference(*args))
    assert (tfc.chain_phases.launches,
            tfc.chain_phases.launches_by_variant) == before


def test_chain_phases_rejects_an_unknown_variant():
    with pytest.raises(ValueError):
        tfc.chain_phases(*_args((4, 14, 14), ("TL",), 1), variant="tiled")


def test_reset_launches():
    tfc.chain_phases.launches += 3
    tfc.chain_phases.launches_by_variant["cluster"] += 3
    tfc.reset_launches()
    assert tfc.chain_phases.launches == 0
    assert tfc.chain_phases.launches_by_variant == {
        "cluster": 0, "cluster_wide": 0, "streaming": 0}
