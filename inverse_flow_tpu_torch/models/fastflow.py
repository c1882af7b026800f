"""FastFlow: the multi-scale ImageNet model with Gaussianize splits.

Port of ``inverse_flow_tpu/models/fastflow.py:build_fastflow``: the
preprocessing, then per level a squeeze and K steps of [``InvFlow`` TL,
optional ActNorm, ``Conv1x1``, ``Coupling``] (one ``RepeatedBlock``), a
``GaussianizeSplit`` between levels, and the standard-normal base. Each
``InvFlow`` is an exact TL solve, one chain kernel launch on the card
forward and one backward. The model needs no change for data parallelism;
the registry's ``if_imagenet_multi_gpu`` config asks for it, which the
port refuses until ROADMAP 1.7.
"""

from __future__ import annotations

from ..distributions import GaussianPrior
from ..layers import (ActNorm, Conv1x1, Coupling, Flow, GaussianizeSplit,
                      InvFlow, RepeatedBlock, Squeeze)
from .glow import build_preprocess


def build_fastflow(data_size=(3, 32, 32), n_blocks=3, block_size=48,
                   actnorm=False, coupling_width=512, if_kernel_size=3,
                   generator=None, device="cuda"):
    """preprocess -> (n_blocks-1) x [squeeze; K x (InvFlow TL; {ActNorm};
    Conv1x1; Coupling); GaussianizeSplit] -> squeeze; K x step -> N(0, I)
    on (C*2^(n_blocks+1), H/2^n_blocks, W/2^n_blocks). The parameters are
    drawn from ``generator`` on ``device``, the CUDA card unless the
    caller names another."""
    init = dict(generator=generator, device=device)
    layers = build_preprocess(data_size, alpha=1e-6)
    size = tuple(data_size)
    for level in range(n_blocks):
        layers.append(Squeeze())
        size = (size[0] * 4, size[1] // 2, size[2] // 2)

        def make_step(size=size):
            step = [InvFlow(size[0], (if_kernel_size, if_kernel_size),
                            order="TL", **init)]
            if actnorm:
                step.append(ActNorm(size[0], **init))
            step.append(Conv1x1(size[0], **init))
            step.append(Coupling(size, width=coupling_width, **init))
            return step

        layers.append(RepeatedBlock(make_step, block_size))
        if level < n_blocks - 1:
            layers.append(GaussianizeSplit(size, device=device))
            size = (size[0] // 2, size[1], size[2])
    return Flow(GaussianPrior(size), layers)
