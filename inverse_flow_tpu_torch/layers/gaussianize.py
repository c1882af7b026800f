"""Gaussianize: the conditionally Gaussian factor-out of FastFlow.

Port of ``inverse_flow_tpu/layers/gaussianize.py``. ``Gaussianize`` maps
the second channel half x2 to ``z2 = (x2 - mu(x1)) * exp(-logs(x1))``, ldj
``-sum logs``, where a zero-initialized 3x3 conv of the first half x1
gives (mu, logs) as its even and odd channels, scaled by a learned
per-channel ``exp(log_scale_factor)``: the layer starts as the identity.
``GaussianizeSplit`` keeps x1 and factors z2 out, its standard-normal
log-density folded into the ldj; its inverse draws z2 from the caller's
generator (or takes it as ``noise``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..distributions import GaussianPrior
from ..ops.convs import conv2d
from .base import FlowLayer, sum_except_batch


class Gaussianize(FlowLayer):
    """Params ``w`` (2C, C, 3, 3), ``b`` (2C,) and ``log_scale_factor``
    (2C, 1, 1), all zero, for ``n_channels`` = C, half of the input's
    channels."""

    def __init__(self, n_channels: int, device=None):
        super().__init__()
        c = n_channels
        self.n_channels = c
        self.w = nn.Parameter(torch.zeros((2 * c, c, 3, 3), device=device))
        self.b = nn.Parameter(torch.zeros((2 * c,), device=device))
        self.log_scale_factor = nn.Parameter(
            torch.zeros((2 * c, 1, 1), device=device))

    def _mu_logs(self, p, x1):
        h = conv2d(x1, p["w"], padding=1) + p["b"].reshape(1, -1, 1, 1)
        h = h * torch.exp(p["log_scale_factor"])[None]
        return h[:, 0::2], h[:, 1::2]

    def forward_split(self, p, x1, x2):
        mu, logs = self._mu_logs(p, x1)
        return (x2 - mu) * torch.exp(-logs), -sum_except_batch(logs)

    def inverse_split(self, p, x1, z2):
        mu, logs = self._mu_logs(p, x1)
        return mu + z2 * torch.exp(logs)

    def forward_with(self, p, x, generator=None):
        c = self.n_channels
        z2, ldj = self.forward_split(p, x[:, :c], x[:, c:])
        return torch.cat([x[:, :c], z2], dim=1), ldj

    def inverse_with(self, p, z, generator=None):
        c = self.n_channels
        return torch.cat([z[:, :c], self.inverse_split(p, z[:, :c],
                                                       z[:, c:])], dim=1)


class GaussianizeSplit(Gaussianize):
    """The channel split of ``input_size`` (C, H, W) with a Gaussianize
    head on its second half: out (B, C//2, H, W), the half's
    ``log N(z2; 0, I)`` added to the ldj. Its parameters are the head's,
    under the same names."""

    def __init__(self, input_size: Tuple[int, int, int], device=None):
        super().__init__(input_size[0] // 2, device=device)
        c, h, w = input_size
        self.base = GaussianPrior((c // 2, h, w))

    def out_shape(self, shape):
        return tuple(self.base.size)

    def forward_with(self, p, x, generator=None):
        c = self.n_channels
        z2, ldj = self.forward_split(p, x[:, :c], x[:, c:])
        return x[:, :c], ldj + self.base.log_prob(z2)

    def inverse_with(self, p, z, generator=None, noise=None):
        """z2 drawn from the base with ``generator`` on z's device, or
        given as ``noise``; raises without either."""
        if noise is None:
            if generator is None:
                raise ValueError(
                    "GaussianizeSplit.inverse needs a generator or noise")
            noise, _ = self.base.sample(generator, z.shape[0],
                                        device=z.device)
        return torch.cat([z, self.inverse_split(p, z, noise)], dim=1)

    def inverse(self, z, generator=None, noise=None):
        return self.inverse_with(self.own_params(), z, generator, noise)
