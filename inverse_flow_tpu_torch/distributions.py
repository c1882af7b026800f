"""Base distributions for the flow (prior and dequantization noise).

Port of ``inverse_flow_tpu/distributions.py``. A standard normal with
identity covariance factorizes, so ``log N(x; 0, I) = -0.5 * sum(x^2 +
log 2pi)``. Sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class GaussianPrior:
    """Standard normal prior over tensors of shape ``size`` (no batch
    dim)."""

    size: Tuple[int, ...]

    def log_prob(self, x):
        x = x.reshape(x.shape[0], -1)
        return -0.5 * (x * x + _LOG_2PI).sum(-1)

    def sample(self, generator, n, device=None):
        x = torch.randn((n,) + tuple(self.size), generator=generator,
                        device=device)
        return x, self.log_prob(x)


@dataclass(frozen=True)
class UniformDistribution:
    """Uniform on [0,1]^d with -1e30 log-density outside the support; the
    dequantization-noise distribution (sample log-prob 0)."""

    size: Tuple[int, ...]

    def log_prob(self, x):
        inside = (x >= 0.0) & (x <= 1.0)
        log_px = torch.where(inside, 0.0, -1e30)
        return log_px.reshape(x.shape[0], -1).sum(-1)

    def sample(self, generator, n, device=None):
        x = torch.rand((n,) + tuple(self.size), generator=generator,
                       device=device)
        return x, torch.zeros((n,), device=device)
