"""Inverse-Flow convolution layers: the inverse of a masked convolution.

Port of ``inverse_flow_tpu/layers/inv_flow.py:InvFlow``/``InvFlowNoPad``
and ``InvFlowUnit``, every solver, both directions. The exact solve
(``'exact'``, ``'fused'``) runs through
:func:`~inverse_flow_tpu_torch.ops.fused_chain.fused_chain_solve` with one
order (four for the unit): the chain kernel on a CUDA tensor, its plain
version on a CPU tensor, in the forward and again (complementary orders,
transposed kernels) in the backward; autograd carries the weight gradient
back through ``apply_mask``. ``'jacobi'`` is the Neumann iteration of
masked convs (``ops/inv_conv.py``) with its implicit VJP; ``'auto'``
resolves per activation shape (``ops/solver_policy.py``) and runs a
routed Jacobi solve residual-guarded. ldj is
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
from ..ops.inv_conv import (apply_mask, inv_conv_solve_jacobi_guarded_implicit,
                            inv_conv_solve_jacobi_implicit, masked_conv_apply)
from ..ops.solver_policy import auto_jacobi_params, resolve_auto
from .base import FlowLayer, zeros_ldj

# the orders of an InvFlowUnit, in the order they are solved
ORDERS = ("TL", "TR", "BL", "BR")
SOLVERS = ("auto", "exact", "fused", "jacobi")


def _xavier_noise(shape, generator, device, gain=0.01):
    fan_in = shape[1] * shape[2] * shape[3]
    fan_out = shape[0] * shape[2] * shape[3]
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn(shape, generator=generator, device=device)


class InvFlow(FlowLayer):
    """forward: ``y = T^{-1} x``, the inverse of the masked conv ``T``;
    inverse: ``x = T y``, the masked conv itself (a plain conv, as in the
    JAX package). ``'exact'`` and ``'fused'`` are the same function here,
    the chain solve; ``'jacobi'`` runs ``jacobi_iters`` masked convs
    (``jacobi_tol`` > 0 stops early); ``'auto'`` is exact outside the
    measured tall-thin window, and inside it the guarded Jacobi solve
    with the nilpotency cap. With ``groups`` > 1 the weight is (C,
    C/groups, KH, KW), masked per group, and the chain solve runs on its
    dense block-diagonal expansion."""

    span_name = "ift.solve"

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 order: str = "TL", solver: str = "exact", groups: int = 1,
                 jacobi_iters: int = 12, jacobi_tol: float = 0.0,
                 generator=None, device=None):
        super().__init__()
        if order not in ORDER_FLAGS:
            raise ValueError(f"unknown order: {order}")
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver: {solver}")
        if channels % groups:
            raise ValueError(f"{channels} channels in {groups} groups")
        self.kernel_size = tuple(kernel_size)
        self.order = order
        self.solver = solver
        self.groups = groups
        self.jacobi_iters = jacobi_iters
        self.jacobi_tol = jacobi_tol
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

    def _eff_solver(self, x_shape):
        """The solver this layer runs at activation shape ``x_shape``:
        ``'auto'`` resolved by ``ops/solver_policy.resolve_auto``."""
        if self.solver != "auto":
            return self.solver
        return resolve_auto(x_shape, self.kernel_size, self.groups)

    def _jacobi_solve(self, x, w_eff):
        """The Jacobi solve: ``'jacobi'`` with the layer's iterations and
        tol as given; a solve that ``'auto'`` routes here residual-guarded
        with the nilpotency cap (``auto_jacobi_params``)."""
        if self.solver != "auto":
            return inv_conv_solve_jacobi_implicit(
                x, w_eff, self.groups, self.jacobi_iters, self.jacobi_tol)
        fast, cap, tol = auto_jacobi_params(
            x.shape, self.groups, self.jacobi_iters, self.jacobi_tol)
        return inv_conv_solve_jacobi_guarded_implicit(
            x, w_eff, self.groups, fast, cap, tol)

    def forward_with(self, p, x, generator=None):
        if self._eff_solver(x.shape) == "jacobi":
            y = self._jacobi_solve(flip_to(x, self.order), self._w_eff(p))
            return flip_to(y, self.order), zeros_ldj(x)
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
    """Four chained InvFlow solves, TL -> TR -> BL -> BR. The exact solve
    is one ``fused_chain_solve``: one chain kernel launch forward and one
    in the backward (``'exact'`` and ``'fused'``, and ``'auto'`` outside
    the Jacobi window, are the same function here: the JAX package's
    fused path and its batched exact chain). ``'jacobi'``, and ``'auto'``
    inside the window, solve order by order through the child convs,
    which are ``'jacobi'`` or ``'auto'`` (so that each routed solve keeps
    its guard). The parameters are ``convs.i.w``, as the JAX pytree
    ``{"convs": [{"w": ...} x 4]}``."""

    span_name = "ift.solve"

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 solver: str = "auto", jacobi_iters: int = 12,
                 jacobi_tol: float = 0.0, generator=None, device=None):
        super().__init__()
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver: {solver}")
        self.kernel_size = tuple(kernel_size)
        self.solver = solver
        per_layer = "jacobi" if solver == "jacobi" else "auto"
        self.convs = nn.ModuleList(
            InvFlow(channels, kernel_size, order=o, solver=per_layer,
                    jacobi_iters=jacobi_iters, jacobi_tol=jacobi_tol,
                    generator=generator, device=device) for o in ORDERS)

    def _eff_solver(self, x_shape):
        if self.solver != "auto":
            return self.solver
        return resolve_auto(x_shape, self.kernel_size)

    def forward_with(self, p, x, generator=None):
        if self._eff_solver(x.shape) == "jacobi":
            ldj = zeros_ldj(x)
            for i, conv in enumerate(self.convs):
                x, l = conv.forward_with({"w": p[f"convs.{i}.w"]}, x)
                ldj = ldj + l
            return x, ldj
        w_effs = tuple(apply_mask(p[f"convs.{i}.w"])
                       for i in range(len(ORDERS)))
        return fused_chain_solve(x, w_effs, ORDERS), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        """The four masked convs, BR -> BL -> TR -> TL."""
        for i in reversed(range(len(ORDERS))):
            z = self.convs[i].inverse_with({"w": p[f"convs.{i}.w"]}, z)
        return z
