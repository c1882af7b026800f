"""Flow composition: layers, then the base distribution.

Port of ``inverse_flow_tpu/layers/sequential.py:Flow`` (forward,
``forward_verbose``, ``cheap_log_prob``, ``data_init``, ``sample``,
``reconstruct``). The ldj of
each layer is added once. No layer of the port has an exact-logdet path or
an exact inverse that differs from its forward or inverse, so the cheap
log-prob is the exact one and there is one kind of sample.
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

    def forward_verbose(self, x, generator=None):
        """:meth:`forward` that also returns each layer's mean ldj under
        the JAX keys ``f"{i:02d}_{type(layer).__name__}"``: (z, log_px,
        {key: 0-d tensor})."""
        logdet = torch.zeros((x.shape[0],), device=x.device)
        per_layer = {}
        for i, layer in enumerate(self.layers):
            x, ldj = layer(x, generator)
            logdet = logdet + ldj
            per_layer[f"{i:02d}_{type(layer).__name__}"] = ldj.mean()
        return x, self.base_distribution.log_prob(x) + logdet, per_layer

    def cheap_log_prob(self, x, generator=None):
        return self.forward(x, generator)[1]

    def _device(self):
        """The parameters' device; the card for a flow without any."""
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cuda")

    @staticmethod
    def _generator(generator, device):
        """``generator``, or a fresh one seeded by the system."""
        if generator is None:
            generator = torch.Generator(device)
            generator.seed()
        return generator

    def _inverse(self, z, generator, noise):
        for i in reversed(range(len(self.layers))):
            extra = {"noise": noise[i]} if i in noise else {}
            z = self.layers[i].inverse(z, generator, **extra)
        return z

    @torch.inference_mode()
    def sample(self, n, generator=None, noise=None):
        """``n`` draws: z from the base, then every layer's inverse in
        reverse order, on the parameters' device. The draws come from
        ``generator`` (a fresh one seeded by the system when None), or
        from ``noise``: a dict of ``"base"`` -> z and
        layer index -> that ``SplitPrior``'s factored-out half."""
        device = self._device()
        generator = self._generator(generator, device)
        noise = noise or {}
        z = noise.get("base")
        if z is None:
            z, _ = self.base_distribution.sample(generator, n, device=device)
        return self._inverse(z, generator, noise)

    @torch.inference_mode()
    def reconstruct(self, x, generator=None):
        """Forward, then inverse. ``generator`` draws the dequantization
        noise and every ``SplitPrior``'s half, which makes the round trip
        lossy there, as in the JAX package."""
        generator = self._generator(generator, x.device)
        for layer in self.layers:
            x, _ = layer(x, generator)
        return self._inverse(x, generator, {})

    @torch.no_grad()
    def data_init(self, x, generator=None):
        """One forward pass applying each layer's data-dependent init
        before running it."""
        for layer in self.layers:
            layer.data_init(x)
            x, _ = layer(x, generator)
