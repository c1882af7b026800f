"""Inverse-Flow convolution layers: the inverse of a masked convolution.

Port of ``inverse_flow_tpu/layers/inv_flow.py:InvFlow``/``InvFlowNoPad``
and ``InvFlowUnit``, exact solver, both directions. The solve runs
through :func:`~inverse_flow_tpu_torch.ops.fused_chain.fused_chain_solve`
with one order (four for the unit): the chain kernel on a CUDA tensor,
its plain version on a CPU tensor, in the forward and again
(complementary orders, transposed kernels) in the backward;
autograd carries the weight gradient back through ``apply_mask``. ldj is
exactly 0 (the masked conv is unit lower triangular in raster order). The
weights are stored in canonical TL orientation; the order's flips are
absorbed into the solve matrices. The inverse (sampling) direction is
the masked conv, a plain ``F.conv2d`` after the order's flips.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.fused_chain import (ORDER_FLAGS, expand_grouped_kernel, flip_to,
                               fused_chain_solve)
from ..ops.inv_conv import apply_mask, masked_conv_apply
from .base import FlowLayer, zeros_ldj

# the orders of an InvFlowUnit, in the order they are solved
ORDERS = ("TL", "TR", "BL", "BR")


def _xavier_noise(shape, generator, device, gain=0.01):
    fan_in = shape[1] * shape[2] * shape[3]
    fan_out = shape[0] * shape[2] * shape[3]
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn(shape, generator=generator, device=device)


class InvFlow(FlowLayer):
    """forward: ``y = T^{-1} x``, the inverse of the masked conv ``T``;
    inverse: ``x = T y``, the masked conv itself (a plain conv, as in the
    JAX package). ``'exact'`` and ``'fused'`` are the same function here,
    the chain solve. With ``groups`` > 1 the weight is (C, C/groups, KH, KW),
    masked per group, and the solve runs on its dense block-diagonal
    expansion."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 order: str = "TL", solver: str = "exact", groups: int = 1,
                 generator=None, device=None):
        super().__init__()
        if order not in ORDER_FLAGS:
            raise ValueError(f"unknown order: {order}")
        if solver in ("auto", "jacobi"):
            raise NotImplementedError(
                f"InvFlow: solver {solver!r} is not ported (ROADMAP 1.6)")
        if solver not in ("exact", "fused"):
            raise ValueError(f"unknown solver: {solver}")
        if channels % groups:
            raise ValueError(f"{channels} channels in {groups} groups")
        self.kernel_size = tuple(kernel_size)
        self.order = order
        self.groups = groups
        self.w = nn.Parameter(_xavier_noise(
            (channels, channels // groups) + self.kernel_size, generator,
            device))

    def _w_eff(self, p):
        """The masked kernel, each group's (C/g, C/g) block masked on its
        own."""
        w = p["w"]
        cg = w.shape[1]
        return torch.cat([apply_mask(w[i:i + cg])
                          for i in range(0, w.shape[0], cg)])

    def forward_with(self, p, x, generator=None):
        w = expand_grouped_kernel(self._w_eff(p), self.groups)
        return fused_chain_solve(x, (w,), (self.order,)), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        x = masked_conv_apply(flip_to(z, self.order), self._w_eff(p),
                              self.groups)
        return flip_to(x, self.order)


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

    def inverse_with(self, p, z, generator=None):
        """The four masked convs, BR -> BL -> TR -> TL."""
        for i in reversed(range(len(ORDERS))):
            z = self.convs[i].inverse_with({"w": p[f"convs.{i}.w"]}, z)
        return z
