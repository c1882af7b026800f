"""ActNorm: per-channel affine with data-dependent initialization.

Port of ``inverse_flow_tpu/layers/actnorm.py``: ``ActNorm`` on 4-D
inputs, ``ActNormFC`` on flat ones, and ``ActNormPlainLayer``, whose
``forward`` gives the activation alone (inside conditioning networks,
where no log-det is kept).
"""

from __future__ import annotations

import torch
from torch import nn

from .base import FlowLayer


class ActNorm(FlowLayer):
    """``out = (x - t) * exp(-log_s)`` per channel; ldj
    ``-sum(log_s) * H * W``; inverse ``z * exp(log_s) + t``."""

    span_name = "ift.actnorm"

    def __init__(self, n_dims: int, generator=None, device=None):
        super().__init__()
        self.n_dims = n_dims
        self.translation = nn.Parameter(
            torch.randn(n_dims, generator=generator, device=device))
        self.log_scale = nn.Parameter(
            torch.randn(n_dims, generator=generator, device=device))

    def data_init_with(self, p, x):
        # over every axis but the channel's; population std (correction=0),
        # as jnp.std
        dims = tuple(i for i in range(x.ndim) if i != 1)
        std, mean = torch.std_mean(x, dim=dims, correction=0)
        with torch.no_grad():
            p["translation"].copy_(mean)
            p["log_scale"].copy_(torch.log(std + 1e-8))

    def forward_with(self, p, x, generator=None):
        t = p["translation"].reshape(1, -1, 1, 1)
        log_s = p["log_scale"].reshape(1, -1, 1, 1)
        ldj = -p["log_scale"].sum() * x.shape[2] * x.shape[3]
        return (x - t) * torch.exp(-log_s), ldj.expand(x.shape[0])

    def inverse_with(self, p, z, generator=None):
        t = p["translation"].reshape(1, -1, 1, 1)
        log_s = p["log_scale"].reshape(1, -1, 1, 1)
        return z * torch.exp(log_s) + t


class ActNormFC(ActNorm):
    """ActNorm on flat (B, n_dims) inputs, as (B, n_dims, 1, 1)."""

    def forward_with(self, p, x, generator=None):
        out, ldj = super().forward_with(p, x.reshape(-1, self.n_dims, 1, 1))
        return out.reshape(-1, self.n_dims), ldj

    def inverse_with(self, p, z, generator=None):
        return super().inverse_with(
            p, z.reshape(-1, self.n_dims, 1, 1)).reshape(-1, self.n_dims)


class ActNormPlainLayer(ActNorm):
    """ActNorm as a plain module: ``forward`` returns the activation and
    drops the ldj."""

    def forward(self, x, generator=None):
        return self.forward_with(self.own_params(), x)[0]
