"""PaddedConv2d and the FincFlow unit.

Port of ``inverse_flow_tpu/layers/padded_conv.py``. The direction is the
mirror of ``InvFlow``'s: the training forward is the masked convolution (a
plain conv, ldj 0), and the inverse, the sampling direction, is its solve
through :func:`~inverse_flow_tpu_torch.ops.fused_chain.fused_chain_solve`:
the chain kernel on a CUDA tensor, its plain version on a CPU tensor.

``FincFlowUnit`` runs four pad orders on four channel chunks side by side.
Each chunk is flipped into the canonical TL orientation, so both directions
are one grouped op (``groups=4``). Its inverse is FincFlow's level 2, all
four orders in one launch: the grouped kernel is expanded into its dense
block-diagonal form and solved as one TL order, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.fused_chain import (ORDER_FLAGS, expand_grouped_kernel, flip_to,
                               fused_chain_solve)
from ..ops.inv_conv import apply_mask, masked_conv_apply
from .base import FlowLayer, zeros_ldj
from .inv_flow import ORDERS

GROUPS = len(ORDERS)


def _normal(shape, generator, device):
    """The reference's init: normal(0, 0.05)."""
    return nn.Parameter(0.05 * torch.randn(shape, generator=generator,
                                           device=device))


class PaddedConv2d(FlowLayer):
    """Masked conv in one pad order with a unit-lower-triangular center
    tap: forward ``z = F_o T F_o x``, inverse its solve."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 order: str = "TL", generator=None, device=None):
        super().__init__()
        if order not in ORDER_FLAGS:
            raise ValueError(f"unknown order: {order}")
        self.order = order
        self.w = _normal((channels, channels) + tuple(kernel_size), generator,
                         device)

    def forward_with(self, p, x, generator=None):
        z = masked_conv_apply(flip_to(x, self.order), apply_mask(p["w"]))
        return flip_to(z, self.order), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        return fused_chain_solve(z, (apply_mask(p["w"]),), (self.order,))


class FincFlowUnit(FlowLayer):
    """Four pad orders over four channel chunks (TL, TR, BL, BR), one
    grouped op in each direction. Every ``solver`` (``'exact'``,
    ``'fused'``, ``'auto'``) runs the inverse on the chain, as the port's
    ``InvFlow`` does. The parameters are ``ws.0`` ... ``ws.3``, each (C/4,
    C/4, KH, KW), as the JAX pytree ``{"ws": [w0, w1, w2, w3]}``."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 solver: str = "exact", generator=None, device=None):
        super().__init__()
        if channels % GROUPS:
            raise ValueError(f"FincFlowUnit: {channels} channels is not a "
                             f"multiple of {GROUPS}")
        if solver not in ("exact", "fused", "auto"):
            raise ValueError(f"unknown solver: {solver}")
        cg = channels // GROUPS
        self.ws = nn.ParameterList(
            _normal((cg, cg) + tuple(kernel_size), generator, device)
            for _ in range(GROUPS))

    @staticmethod
    def _canonical(x):
        """Each chunk flipped into TL orientation; its own inverse."""
        return torch.cat([flip_to(chunk, o) for chunk, o in
                          zip(x.chunk(GROUPS, dim=1), ORDERS)], dim=1)

    @staticmethod
    def _w_eff(p):
        return torch.cat([apply_mask(p[f"ws.{i}"]) for i in range(GROUPS)])

    def forward_with(self, p, x, generator=None):
        zc = masked_conv_apply(self._canonical(x), self._w_eff(p), GROUPS)
        return self._canonical(zc), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        w = expand_grouped_kernel(self._w_eff(p), GROUPS)
        return self._canonical(fused_chain_solve(self._canonical(z), (w,),
                                                 ("TL",)))
