"""Base distributions for the flow (prior and dequantization noise).

Port of ``inverse_flow_tpu/distributions.py``: the standard normal, the
uniform dequantization noise, the Laplace prior and the diagonal Gaussian.
A standard normal with identity covariance factorizes, so ``log N(x; 0, I)
= -0.5 * sum(x^2 + log 2pi)``. Sampling draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _on(t, device):
    return t if device is None else t.to(device)


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


@dataclass(frozen=True)
class LaplacePrior:
    """Centered Laplace with std 1, constant terms ignored: ``log p(x) =
    -sqrt(2) * sum |x|``."""

    size: Tuple[int, ...]

    def log_prob(self, x):
        return -math.sqrt(2.0) * x.reshape(x.shape[0], -1).abs().sum(-1)

    def sample(self, generator, n, device=None):
        # as jax.random.laplace: u uniform in (-1, 1), sign(u) log1p(-|u|)
        u = torch.rand((n,) + tuple(self.size), generator=generator,
                       device=device)
        u = (2.0 * u - 1.0).clamp_min(-1.0 + np.finfo(np.float32).epsneg)
        x = torch.sign(u) * torch.log1p(-u.abs()) / math.sqrt(2.0)
        return x, self.log_prob(x)


class DiagonalGaussianPrior:
    """Diagonal Gaussian with ``mean`` and ``log_std`` vectors (zeros by
    default). With ``clean_inputs`` the density first replaces NaN by 0
    and +-inf by +-1e10, then clips to ``[-clip, clip]``. ``nll`` is the
    negative log-likelihood summed over the batch."""

    def __init__(self, size, mean=None, log_std=None, clean_inputs=True,
                 clip=10.0):
        self.size = tuple(size) if hasattr(size, "__len__") else (int(size),)
        self.dim = int(math.prod(self.size))
        self.mean = (torch.zeros(self.dim) if mean is None
                     else torch.as_tensor(mean, dtype=torch.float32).ravel())
        self.log_std = (torch.zeros(self.dim) if log_std is None else
                        torch.as_tensor(log_std, dtype=torch.float32).ravel())
        self.clean_inputs = clean_inputs
        self.clip = clip

    def _flat(self, x):
        x = x.reshape(x.shape[0], self.dim)
        if self.clean_inputs:
            x = torch.nan_to_num(x, nan=0.0, posinf=1e10, neginf=-1e10)
            x = x.clamp(-self.clip, self.clip)
        return x

    def log_prob(self, x):
        mean, log_std = self.mean.to(x.device), self.log_std.to(x.device)
        z = (self._flat(x) - mean) * torch.exp(-log_std)
        return (-0.5 * z * z - log_std - 0.5 * _LOG_2PI).sum(-1)

    def nll(self, x):
        return -self.log_prob(x).sum()

    def sample(self, generator, n, device=None):
        """``n`` draws and the log-density of each draw it returns,
        computed from the normal draw itself (the clean and clip of
        ``log_prob`` would score another point where a draw lies beyond
        ``clip``)."""
        mean, log_std = _on(self.mean, device), _on(self.log_std, device)
        eps = torch.randn((n, self.dim), generator=generator, device=device)
        x = (mean + eps * torch.exp(log_std)).reshape((n,) + self.size)
        return x, (-0.5 * eps * eps - log_std - 0.5 * _LOG_2PI).sum(-1)
