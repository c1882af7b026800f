"""Flow composition: layers, then the base distribution.

Port of ``inverse_flow_tpu/layers/sequential.py:Flow`` (forward,
``cheap_log_prob``, ``data_init``). The ldj of each layer is added once.
No layer of the port has an exact-logdet path that differs from its
forward, so the cheap log-prob is the exact one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .base import FlowLayer


class Flow(nn.Module):
    """A sequence of invertible layers with a base distribution."""

    def __init__(self, base_distribution, layers: Sequence[FlowLayer]):
        super().__init__()
        self.base_distribution = base_distribution
        self.layers = nn.ModuleList(layers)

    def forward(self, x, generator=None):
        """Run all layers; returns (z, log_px), log_px including the base
        log-prob."""
        logdet = torch.zeros((x.shape[0],), device=x.device)
        for layer in self.layers:
            x, ldj = layer(x, generator)
            logdet = logdet + ldj
        return x, self.base_distribution.log_prob(x) + logdet

    def cheap_log_prob(self, x, generator=None):
        return self.forward(x, generator)[1]

    @torch.no_grad()
    def data_init(self, x, generator=None):
        """One forward pass applying each layer's data-dependent init
        before running it."""
        for layer in self.layers:
            layer.data_init(x)
            x, _ = layer(x, generator)
