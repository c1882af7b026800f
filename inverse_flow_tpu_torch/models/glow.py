"""Glow-style model builder.

Port of ``inverse_flow_tpu/models/glow.py:build_glow`` for the step kinds
``inv_conv_no_pad`` (the flagship ``if_glow_mnist``), ``inv_flow_unit``
with its ``_exact``/``_fused`` spellings (the ``imagenet32`` bench
config) and ``ff`` (``FincFlowUnit``, ``ff_glow_mnist``), and the
activations ``Spline`` and ``SLR``: squeeze + K steps of
[ActNorm, step layer, activation, Coupling] per block, a SplitPrior
between blocks.
"""

from __future__ import annotations

from ..distributions import GaussianPrior, UniformDistribution
from ..layers import (ActNorm, Coupling, Dequantization, FincFlowUnit, Flow,
                      InvFlowNoPad, InvFlowUnit, LogitTransform, Normalization,
                      RepeatedBlock, SmoothLeakyRelu, SplineActivation,
                      SplitPrior, Squeeze)

# the InvFlowUnit step kinds of the JAX ``_step_layer``, by solver
_UNIT_SOLVERS = {"inv_flow_unit": "auto", "inv_flow_unit_exact": "exact",
                 "inv_flow_unit_fused": "fused"}


def make_activation(name: str, n_bins=5, tail_bound=20.0, generator=None,
                    device=None):
    """Activation factory of the JAX package (``SLR`` and ``Spline``):
    a function of the step's (C, H, W)."""
    if name == "SLR":
        return lambda size: SmoothLeakyRelu(alpha=0.3)
    if name == "Spline":
        return lambda size: SplineActivation(
            tuple(size), n_bins=n_bins, tail_bound=tail_bound,
            generator=generator, device=device)
    raise NotImplementedError(f"activation {name!r} is not ported")


def _step_layer(kind: str, c: int, kernel, **init):
    if kind == "inv_conv_no_pad":
        return InvFlowNoPad(c, kernel, **init)
    if kind == "ff":
        return FincFlowUnit(c, (3, 3), **init)      # 3x3, as in JAX
    return InvFlowUnit(c, kernel, solver=_UNIT_SOLVERS[kind], **init)


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
               remat=False, coupling_remat=True, coupling_dtype="float32",
               generator=None, device="cuda"):
    """Glow stack with the JAX builder's arguments and defaults
    (``remat``: checkpoint every step of a block; ``coupling_remat``:
    checkpoint every coupling net). The parameters are drawn from
    ``generator`` on ``device``, the CUDA card unless the caller names
    another."""
    if step_kind not in ("inv_conv_no_pad", "ff") and \
            step_kind not in _UNIT_SOLVERS:
        raise NotImplementedError(f"step kind {step_kind!r} is not ported")
    if coupling_dtype != "float32":
        raise NotImplementedError(
            f"coupling_dtype {coupling_dtype!r} is not ported")
    init = dict(generator=generator, device=device)
    act = make_activation(activation, n_bins=n_bins, tail_bound=tail_bound,
                          **init)
    kernel = (if_kernel_size, if_kernel_size)
    layers = build_preprocess(data_size, alpha=alpha)
    size = tuple(data_size)
    for level in range(num_blocks):
        layers.append(Squeeze())
        size = (size[0] * 4, size[1] // 2, size[2] // 2)

        def make_step(size=size):
            step = [ActNorm(size[0], **init)] if actnorm else []
            step.append(_step_layer(step_kind, size[0], kernel, **init))
            step.append(act(size))
            step.append(Coupling(size, width=coupling_width,
                                 remat_net=coupling_remat, **init))
            return step

        layers.append(RepeatedBlock(make_step, block_size, remat=remat))
        if split_prior and level < num_blocks - 1:
            layers.append(SplitPrior(size, width=coupling_width,
                                     remat_net=coupling_remat, **init))
            size = (size[0] // 2, size[1], size[2])
    return Flow(GaussianPrior(size), layers)
