"""Invertible 1x1 convolutions (Glow) and the Householder variant.

Port of ``inverse_flow_tpu/layers/conv1x1.py``: a channel matmul, ldj
``H*W*slogdet(W)``, the inverse through ``torch.linalg.inv``; the
Householder form is orthogonal by construction, ldj 0.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import FlowLayer, zeros_ldj


def _channel_mix(m, x):
    """``z[b, o] = sum_c m[o, c] x[b, c]`` at every pixel."""
    return torch.einsum("oc,bchw->bohw", m, x)


class Conv1x1(FlowLayer):
    """Glow's invertible 1x1 conv; param ``W`` (C, C), the Q of a Gaussian
    matrix's QR."""

    def __init__(self, n_channels: int, generator=None, device=None):
        super().__init__()
        a = torch.randn((n_channels, n_channels), generator=generator,
                        device=device)
        self.W = nn.Parameter(torch.linalg.qr(a)[0])

    def forward_with(self, p, x, generator=None):
        w = p["W"]
        ldj = x.shape[2] * x.shape[3] * torch.linalg.slogdet(w)[1]
        return _channel_mix(w, x), ldj.expand(x.shape[0])

    def inverse_with(self, p, z, generator=None):
        return _channel_mix(torch.linalg.inv(p["W"]), z)


class Conv1x1Householder(FlowLayer):
    """Orthogonal 1x1 conv, the product of ``n_reflections`` Householder
    reflections of the rows of param ``V`` (n_reflections, C); ldj 0."""

    def __init__(self, n_channels: int, n_reflections: int, generator=None,
                 device=None):
        super().__init__()
        self.n_channels = n_channels
        self.V = nn.Parameter(torch.randn((n_reflections, n_channels),
                                          generator=generator,
                                          device=device))

    def _construct_q(self, p):
        v = p["V"]
        eye = torch.eye(self.n_channels, dtype=v.dtype, device=v.device)
        q = eye
        for vi in v:
            vi = vi.reshape(-1, 1)
            q = q @ (eye - 2.0 * (vi @ vi.T) / (vi.T @ vi))
        return q

    def forward_with(self, p, x, generator=None):
        return _channel_mix(self._construct_q(p), x), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        return _channel_mix(self._construct_q(p).T, z)
