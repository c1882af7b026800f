"""Emerging convolutions (Hoogeboom et al.).

Port of ``inverse_flow_tpu/layers/emerging.py``. The square
autoregressive 2x2 conv has the raster-order triangular structure of the
masked conv, with a learnable diagonal in place of a unit one, so its
inverse is the chain solve: one TL order on the hand-written chain kernel
(a CUDA tensor) or its plain version (a CPU tensor), whose operator build
takes a non-unit diagonal (``ops/inv_conv.py:_tri_inverse``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.fused_chain import fused_chain_solve
from ..ops.inv_conv import masked_conv_apply
from .base import FlowLayer, sub_params, zeros_ldj
from .conv1x1 import Conv1x1


def square_ar_mask(c: int, kh: int = 2, kw: int = 2, device=None):
    """Every tap free but the centre (last) tap, which is lower triangular
    with its diagonal."""
    mask = torch.ones((c, c, kh, kw), device=device)
    mask[:, :, -1, -1] = torch.ones((c, c), device=device).tril()
    return mask


class SquareAutoRegressiveConv2d(FlowLayer):
    """2x2 autoregressive conv with params ``w`` (C, C, 2, 2), ``b`` (C,);
    ldj ``H*W*sum log|diag|``; the inverse is the chain solve."""

    def __init__(self, n_channels: int, generator=None, device=None):
        super().__init__()
        c = n_channels
        w = torch.randn((c, c, 2, 2), generator=generator,
                        device=device) / math.sqrt(c * c * 4)
        w[torch.arange(c), torch.arange(c), -1, -1] += 1.0
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros((c,), device=device))

    def _w_eff(self, p):
        w = p["w"]
        return w * square_ar_mask(w.shape[0], device=w.device)

    def forward_with(self, p, x, generator=None):
        w = p["w"]
        diag = torch.diagonal(w[:, :, -1, -1])
        ld = torch.log(diag.abs()).sum() * x.shape[2] * x.shape[3]
        z = masked_conv_apply(x, self._w_eff(p)) + p["b"].reshape(1, -1, 1, 1)
        return z, ld.expand(x.shape[0])

    def inverse_with(self, p, z, generator=None):
        return fused_chain_solve(z - p["b"].reshape(1, -1, 1, 1),
                                 (self._w_eff(p),), ("TL",))


class Flip2d(FlowLayer):
    """Spatial 180-degree flip."""

    def forward_with(self, p, x, generator=None):
        return x.flip((2, 3)), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        return z.flip((2, 3))


class Emerging(FlowLayer):
    """A 1x1 conv, then two autoregressive convs each followed by a flip.
    The five transforms are the ``nn.ModuleList`` ``t``, so the params
    are ``t.0.W``, ``t.1.w``, ``t.1.b``, ``t.3.w``, ``t.3.b`` (the JAX
    tree ``{"t": [..., {}]}``, the flips' entries empty)."""

    def __init__(self, n_channels: int, generator=None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.t = nn.ModuleList([
            Conv1x1(n_channels, **init),
            SquareAutoRegressiveConv2d(n_channels, **init), Flip2d(),
            SquareAutoRegressiveConv2d(n_channels, **init), Flip2d()])

    def forward_with(self, p, x, generator=None):
        ldj = zeros_ldj(x)
        for i, t in enumerate(self.t):
            x, l = t.forward_with(sub_params(p, f"t.{i}"), x)
            ldj = ldj + l
        return x, ldj

    def inverse_with(self, p, z, generator=None):
        for i in reversed(range(len(self.t))):
            z = self.t[i].inverse_with(sub_params(p, f"t.{i}"), z)
        return z
