"""Glow-style model builder.

Port of ``inverse_flow_tpu/models/glow.py:build_glow`` for
``step_kind="inv_conv_no_pad"`` and ``activation="Spline"``: squeeze + K
steps of [ActNorm, InvFlowNoPad, SplineActivation, Coupling] per block, a
SplitPrior between blocks.
"""

from __future__ import annotations

from ..distributions import GaussianPrior, UniformDistribution
from ..layers import (ActNorm, Coupling, Dequantization, Flow, InvFlowNoPad,
                      LogitTransform, Normalization, RepeatedBlock,
                      SplineActivation, SplitPrior, Squeeze)


def build_preprocess(data_size, alpha=1e-6):
    """Dequant + normalize + logit."""
    return [
        Dequantization(UniformDistribution(tuple(data_size))),
        Normalization(translation=0.0, scale=256.0),
        Normalization(translation=-alpha, scale=1.0 / (1.0 - 2.0 * alpha)),
        LogitTransform(),
    ]


def build_glow(data_size=(1, 28, 28), step_kind="inv_conv_no_pad",
               num_blocks=2, block_size=16, coupling_width=512,
               actnorm=True, split_prior=True, activation="Spline",
               n_bins=5, tail_bound=20.0, if_kernel_size=3, alpha=1e-7,
               remat=False, coupling_remat=True, generator=None,
               device=None):
    """Glow stack with the JAX builder's arguments and defaults
    (``remat``: checkpoint every step of a block; ``coupling_remat``:
    checkpoint every coupling net). The parameters are drawn from
    ``generator`` on ``device``."""
    if step_kind != "inv_conv_no_pad":
        raise NotImplementedError(f"step kind {step_kind!r} is not ported")
    if activation != "Spline":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    init = dict(generator=generator, device=device)
    layers = build_preprocess(data_size, alpha=alpha)
    size = tuple(data_size)
    for level in range(num_blocks):
        layers.append(Squeeze())
        size = (size[0] * 4, size[1] // 2, size[2] // 2)

        def make_step(size=size):
            step = [ActNorm(size[0], **init)] if actnorm else []
            step.append(InvFlowNoPad(
                size[0], (if_kernel_size, if_kernel_size), **init))
            step.append(SplineActivation(size, n_bins=n_bins,
                                         tail_bound=tail_bound, **init))
            step.append(Coupling(size, width=coupling_width,
                                 remat_net=coupling_remat, **init))
            return step

        layers.append(RepeatedBlock(make_step, block_size, remat=remat))
        if split_prior and level < num_blocks - 1:
            layers.append(SplitPrior(size, width=coupling_width,
                                     remat_net=coupling_remat, **init))
            size = (size[0] // 2, size[1], size[2])
    return Flow(GaussianPrior(size), layers)
