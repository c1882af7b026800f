"""Inverse-Flow convolution layers: the inverse of a masked convolution.

Port of ``inverse_flow_tpu/layers/inv_flow.py:InvFlow``/``InvFlowNoPad``
and ``InvFlowUnit``, training direction, exact solver. The solve runs
through :func:`~inverse_flow_tpu_torch.ops.fused_chain.fused_chain_solve`
with one order (four for the unit): the chain kernel on a CUDA tensor,
its plain version on a CPU tensor, in the forward and again
(complementary orders, transposed kernels) in the backward;
autograd carries the weight gradient back through ``apply_mask``. ldj is
exactly 0 (the masked conv is unit lower triangular in raster order). The
weights are stored in canonical TL orientation; the order's flips are
absorbed into the solve matrices.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.fused_chain import ORDER_FLAGS, fused_chain_solve
from ..ops.inv_conv import apply_mask
from .base import FlowLayer, zeros_ldj

# the orders of an InvFlowUnit, in the order they are solved
ORDERS = ("TL", "TR", "BL", "BR")


def _xavier_noise(shape, generator, device, gain=0.01):
    fan_in = shape[1] * shape[2] * shape[3]
    fan_out = shape[0] * shape[2] * shape[3]
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn(shape, generator=generator, device=device)


class InvFlow(FlowLayer):
    """forward: ``y = T^{-1} x``, the inverse of the masked conv ``T``."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 order: str = "TL", solver: str = "exact", generator=None,
                 device=None):
        super().__init__()
        if order not in ORDER_FLAGS:
            raise ValueError(f"unknown order: {order}")
        if solver != "exact":
            raise NotImplementedError(
                f"InvFlow: solver {solver!r} is not ported; use 'exact'")
        self.kernel_size = tuple(kernel_size)
        self.order = order
        self.w = nn.Parameter(_xavier_noise(
            (channels, channels) + self.kernel_size, generator, device))

    def forward_with(self, p, x, generator=None):
        y = fused_chain_solve(x, (apply_mask(p["w"]),), (self.order,))
        return y, zeros_ldj(x)


class InvFlowNoPad(InvFlow):
    """The reference's no-pad variant: the TL layer, with InvFlow's
    arguments and defaults, as in the JAX package."""


class InvFlowUnit(FlowLayer):
    """Four chained InvFlow solves, TL -> TR -> BL -> BR, in one
    ``fused_chain_solve``: one chain kernel launch forward and one in the
    backward. ``'auto'``, ``'exact'`` and ``'fused'`` are the same
    function here (the JAX package's fused path and its batched exact
    chain); ``'jacobi'`` is not ported. The parameters are ``convs.i.w``,
    as the JAX pytree ``{"convs": [{"w": ...} x 4]}``."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 solver: str = "auto", generator=None, device=None):
        super().__init__()
        if solver == "jacobi":
            raise NotImplementedError("InvFlowUnit: the Jacobi solver is "
                                      "not ported")
        if solver not in ("auto", "exact", "fused"):
            raise ValueError(f"unknown solver: {solver}")
        self.convs = nn.ModuleList(
            InvFlow(channels, kernel_size, order=o, generator=generator,
                    device=device) for o in ORDERS)

    def forward_with(self, p, x, generator=None):
        w_effs = tuple(apply_mask(p[f"convs.{i}.w"])
                       for i in range(len(ORDERS)))
        return fused_chain_solve(x, w_effs, ORDERS), zeros_ldj(x)
