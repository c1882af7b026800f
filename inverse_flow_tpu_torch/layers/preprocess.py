"""Preprocessing layers: dequantization, normalization, logit and sigmoid;
their inverses floor, rescale, and take the sigmoid and the logit.

Port of ``inverse_flow_tpu/layers/preprocess.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributions import UniformDistribution
from .base import FlowLayer, sum_except_batch


class Dequantization(FlowLayer):
    """Uniform dequantization ``x + u`` with ``ldj = -log q(u)`` (0 for
    uniform noise). The noise comes from ``generator``, or is given as
    ``noise`` (tests inject the same noise into both packages)."""

    is_preprocessing = True

    def __init__(self, distribution: UniformDistribution):
        super().__init__()
        self.distribution = distribution

    def forward_with(self, p, x, generator=None, noise=None):
        if noise is None:
            if generator is None:
                raise ValueError(
                    "Dequantization.forward needs a generator or noise")
            noise, log_qnoise = self.distribution.sample(
                generator, x.shape[0], device=x.device)
        else:
            log_qnoise = self.distribution.log_prob(noise)
        return x + noise, -log_qnoise

    def forward(self, x, generator=None, noise=None):
        return self.forward_with({}, x, generator, noise)

    def inverse_with(self, p, z, generator=None):
        return torch.floor(z)


class Normalization(FlowLayer):
    """Affine ``(x - translation) / scale`` with ``ldj = -D*log(scale)``."""

    is_preprocessing = True

    def __init__(self, translation: float, scale: float):
        super().__init__()
        self.translation = translation
        self.scale = scale

    def forward_with(self, p, x, generator=None):
        z = (x - self.translation) / self.scale
        d = int(np.prod(x.shape[1:]))
        # log of the float32 scale, as the JAX package computes it
        ldj = -d * np.log(np.float32(self.scale))
        return z, torch.full((x.shape[0],), float(ldj), device=x.device)

    def inverse_with(self, p, z, generator=None):
        return z * self.scale + self.translation


class LogitTransform(FlowLayer):
    """``z = logit(x)`` with ``ldj = sum(-log x - log(1-x))``."""

    is_preprocessing = True

    def forward_with(self, p, x, generator=None):
        z = torch.log(x) - torch.log1p(-x)
        return z, sum_except_batch(-torch.log(x) - torch.log1p(-x))

    def inverse_with(self, p, z, generator=None):
        return torch.sigmoid(z)


class SigmoidTransform(FlowLayer):
    """``z = sigmoid(x)`` with ``ldj = sum(log sigmoid(x) + log
    sigmoid(-x))``, both in their stable forms; the inverse is the
    logit."""

    is_preprocessing = True

    def forward_with(self, p, x, generator=None):
        return torch.sigmoid(x), sum_except_batch(F.logsigmoid(x)
                                                  + F.logsigmoid(-x))

    def inverse_with(self, p, z, generator=None):
        return torch.log(z) - torch.log1p(-z)
