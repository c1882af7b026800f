"""Model builders: the Glow stack, the plain CNN stack and the FC stack.

Port of ``inverse_flow_tpu/models/glow.py`` (``build_glow``,
``build_cnn_flow``, ``build_fc_flow``) for the step kinds
``inv_conv_no_pad`` (the flagship ``if_glow_mnist``) with its
``inv_conv_auto``/``inv_conv_jacobi`` solvers, ``inv_conv`` (``InvFlow``
TL), ``inv_flow_unit`` with its ``_exact``/``_fused``/``_jacobi``
spellings (the ``imagenet32`` bench config), ``ff`` (``FincFlowUnit``),
``snf``/``snf_cnn`` (SelfNorm 1x1 and 3x3), ``conv1x1``, ``emerging`` and
``convexp``, and every activation of the JAX factory. The Glow stack is
squeeze + K steps of [ActNorm, step layer, activation, Coupling] per
block, a SplitPrior between blocks; ``coupling_dtype`` sets every
Coupling's and SplitPrior's net precision (float32, or bf16 as
``"bfloat16"``/``"bf16"``).
"""

from __future__ import annotations

import numpy as np

from ..distributions import GaussianPrior, UniformDistribution
from ..layers import (ActNorm, BSplineActivation, Conv1x1, ConvExp, Coupling,
                      Dequantization, Emerging, FincFlowUnit, Flow, Identity,
                      InvFlow, InvFlowNoPad, InvFlowUnit, LogitTransform,
                      Normalization, RepeatedBlock, SelfNormConv, SelfNormFC,
                      SmoothLeakyRelu, SplineActivation, SplitPrior, Squeeze)

# the InvFlowUnit step kinds of the JAX ``_step_layer``, by solver
_UNIT_SOLVERS = {"inv_flow_unit": "auto", "inv_flow_unit_exact": "exact",
                 "inv_flow_unit_fused": "fused",
                 "inv_flow_unit_jacobi": "jacobi"}
# the InvFlowNoPad step kinds, by solver
_NO_PAD_SOLVERS = {"inv_conv_no_pad": "exact", "inv_conv_auto": "auto",
                   "inv_conv_jacobi": "jacobi"}


def make_activation(name, n_bins=5, tail_bound=20.0, generator=None,
                    device=None):
    """Activation factory of the JAX package: a function of the step's
    size, or None for ``None``. ``Spline`` and ``SplineNat`` both give the
    per-position RQ spline (JAX's ``SplineNat`` differs only in the
    ``tile_params`` compiler switch); ``BSpline`` the B-spline activation,
    ``SLR`` the smooth leaky ReLU, ``Identity`` the identity."""
    if name in (None, "None", "none"):
        return None
    if name == "SLR":
        return lambda size: SmoothLeakyRelu(alpha=0.3)
    if name in ("Spline", "SplineNat"):
        return lambda size: SplineActivation(
            tuple(size), n_bins=n_bins, tail_bound=tail_bound,
            generator=generator, device=device)
    if name == "BSpline":
        return lambda size: BSplineActivation(
            n_bins=n_bins, tail_bound=tail_bound, generator=generator,
            device=device)
    if name == "Identity":
        return lambda size: Identity()
    raise ValueError(f"unknown activation: {name}")


def _step_layer(kind: str, c: int, kernel, size=None, **init):
    """The step layer of kind ``kind`` on ``c`` channels (``size``: the
    step's (C, H, W), which ConvExp needs); raises ValueError on an
    unknown kind."""
    if kind in _NO_PAD_SOLVERS:
        return InvFlowNoPad(c, kernel, solver=_NO_PAD_SOLVERS[kind], **init)
    if kind == "inv_conv":
        return InvFlow(c, kernel, order="TL", **init)
    if kind == "ff":
        return FincFlowUnit(c, (3, 3), **init)      # 3x3, as in JAX
    if kind in _UNIT_SOLVERS:
        return InvFlowUnit(c, kernel, solver=_UNIT_SOLVERS[kind], **init)
    if kind == "snf":
        return SelfNormConv(c, c, (1, 1), bias=True, **init)
    if kind == "snf_cnn":
        return SelfNormConv(c, c, (3, 3), bias=True, padding=1, **init)
    if kind == "conv1x1":
        return Conv1x1(c, **init)
    if kind == "emerging":
        return Emerging(c, **init)
    if kind == "convexp":
        return ConvExp(tuple(size), **init)
    raise ValueError(f"unknown step layer: {kind}")


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
    checkpoint every coupling net; ``coupling_dtype``: the coupling nets'
    precision, ``"float32"``, ``"bfloat16"`` or ``"bf16"``). The parameters
    are drawn from ``generator`` on ``device``, the CUDA card unless the
    caller names another."""
    init = dict(generator=generator, device=device)
    net = dict(remat_net=coupling_remat, compute_dtype=coupling_dtype)
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
            step.append(_step_layer(step_kind, size[0], kernel, size,
                                    **init))
            if act is not None:
                step.append(act(size))
            step.append(Coupling(size, width=coupling_width, **net,
                                 **init))
            return step

        layers.append(RepeatedBlock(make_step, block_size, remat=remat))
        if split_prior and level < num_blocks - 1:
            layers.append(SplitPrior(size, width=coupling_width, **net,
                                     **init))
            size = (size[0] // 2, size[1], size[2])
    return Flow(GaussianPrior(size), layers)


def build_cnn_flow(data_size=(1, 28, 28), step_kind="inv_conv_no_pad",
                   num_blocks=3, block_size=16, activation="Spline",
                   n_bins=10, tail_bound=30.0, kernel=(2, 2), alpha=1e-6,
                   generator=None, device="cuda"):
    """Plain CNN stack with the JAX builder's arguments and defaults:
    per block ``block_size`` step layers, each followed by an activation
    but the very last, and a squeeze between blocks."""
    init = dict(generator=generator, device=device)
    act = make_activation(activation, n_bins=n_bins, tail_bound=tail_bound,
                          **init)
    layers = build_preprocess(data_size, alpha=alpha)
    size = tuple(data_size)
    for b in range(num_blocks):
        for l in range(block_size):
            layers.append(_step_layer(step_kind, size[0], kernel, size,
                                      **init))
            if act is not None and not (b == num_blocks - 1
                                        and l == block_size - 1):
                layers.append(act(size))
        if b != num_blocks - 1:
            layers.append(Squeeze())
            size = (size[0] * 4, size[1] // 2, size[2] // 2)
    return Flow(GaussianPrior(size), layers)


def build_fc_flow(data_size=(1, 28, 28), num_layers=2,
                  kind="inv_conv_no_pad", activation="Spline",
                  tail_bound=10.0, alpha=1e-6, generator=None,
                  device="cuda"):
    """FC stack with the JAX builder's arguments and defaults: ``snf_fc``
    is ``SelfNormFC`` on the flat vector; every other kind is that step
    layer, 3x3, on the image (as the reference's ``exact_fc_mnist``). An
    activation sits between the layers."""
    init = dict(generator=generator, device=device)
    layers = build_preprocess(data_size, alpha=alpha)
    size = tuple(data_size)
    dim = int(np.prod(size))
    act = make_activation(activation, tail_bound=tail_bound, **init)
    for l in range(num_layers):
        if kind == "snf_fc":
            layers.append(SelfNormFC(dim, dim, bias=True, **init))
            if act is not None and (l + 1) < num_layers:
                layers.append(act((dim,)))
        else:
            layers.append(_step_layer(kind, size[0], (3, 3), size, **init))
            if act is not None and (l + 1) < num_layers:
                layers.append(act(size))
    final = (dim,) if kind == "snf_fc" else size
    return Flow(GaussianPrior(final), layers)
