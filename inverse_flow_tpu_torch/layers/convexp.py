"""Convolution exponential: z = exp(M) x by a truncated series.

Port of ``inverse_flow_tpu/layers/convexp.py``: a 1x1 mix, then the
exponential of a spectrally normalized 3x3 conv M, ``sum_k M^k x / k!``,
6 terms in training and 13 on the exact path and in the inverse (which
runs the series on -M). The series is plain cuDNN convs, as JAX leaves it
to XLA. ldj = H*W*tr(M's center taps) plus the 1x1 mix's.

Spectral normalization divides the kernel by ``max(1, sigma/coeff) +
1e-5``, sigma estimated by one power iteration from the vector ``u`` that
the layer carries among its parameters (``requires_grad=False``): the
optimizer and the clamp leave it alone, and :meth:`ConvExp.update_carry_with`
advances it by one iteration against the new kernel after every optimizer
step (10 in data init), as JAX's ``update_carry``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..ops.convs import conv2d, conv2d_input_grad
from .base import FlowLayer, sub_params
from .conv1x1 import Conv1x1, Conv1x1Householder


def _pad(kernel):
    return ((kernel.shape[2] - 1) // 2, (kernel.shape[3] - 1) // 2)


def conv_exp(x, kernel, terms):
    """``sum_{k <= terms} conv^k(x) / k!``."""
    pad = _pad(kernel)
    result = product = x
    for i in range(1, terms + 1):
        product = conv2d(product, kernel, padding=pad) / i
        result = result + product
    return result


def conv_exp_logdet(kernel, h, w):
    """The exponential's ldj, ``tr(M) = H*W*sum(diag of the center
    taps)``."""
    c = kernel.shape[0]
    m1, m2 = _pad(kernel)
    idx = torch.arange(c, device=kernel.device)
    return kernel[idx, idx, m1, m2].sum() * h * w


def _normalize(v, eps):
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(kernel, u, input_dim, coeff, n_iter=1, eps=1e-12):
    """``n_iter`` power iterations from ``u`` on the conv at ``input_dim``
    (C, H, W): v = normalize(conv^T(u)), u = normalize(conv(v)); then
    sigma = <u, conv(v)> with u and v held constant. Returns
    ``(kernel / (max(1, sigma/coeff) + 1e-5), u, sigma)``."""
    c, h, w = input_dim
    pad = _pad(kernel)
    with torch.no_grad():
        k = kernel.detach()
        for _ in range(n_iter):
            v = _normalize(conv2d_input_grad(
                u.reshape(1, c, h, w), k, (1, c, h, w),
                padding=pad).reshape(-1), eps)
            u = _normalize(conv2d(v.reshape(1, c, h, w), k,
                                  padding=pad).reshape(-1), eps)
    wv = conv2d(v.reshape(1, c, h, w), kernel, padding=pad).reshape(-1)
    sigma = torch.dot(u, wv)
    factor = torch.clamp(sigma / coeff, min=1.0)
    return kernel / (factor + 1e-5), u, sigma


class ConvExp(FlowLayer):
    """Params ``kernel`` (C, C, 3, 3), normal / (9C); ``pre_bias`` and
    ``post_bias`` (1, C, H, W), zeros; ``conv1x1``: ``Conv1x1(C)`` for C
    <= 64, else ``Conv1x1Householder(C, 64)``; and the carried unit vector
    ``u`` (C*H*W,)."""

    has_carry = True

    def __init__(self, input_size: Tuple[int, int, int], coeff: float = 0.9,
                 n_terms_train: int = 6, generator=None, device=None):
        super().__init__()
        self.input_size = tuple(input_size)
        self.coeff = coeff
        self.n_terms_train = n_terms_train
        c = self.input_size[0]
        init = dict(generator=generator, device=device)
        self.kernel = nn.Parameter(
            torch.randn((c, c, 3, 3), **init) / (c * 9))
        self.pre_bias = nn.Parameter(
            torch.zeros((1,) + self.input_size, device=device))
        self.post_bias = nn.Parameter(
            torch.zeros((1,) + self.input_size, device=device))
        u = torch.randn((math.prod(self.input_size),), **init)
        self.u = nn.Parameter(u / torch.linalg.vector_norm(u),
                              requires_grad=False)
        self.conv1x1 = (Conv1x1(c, **init) if c <= 64
                        else Conv1x1Householder(c, 64, **init))

    @property
    def n_terms_eval(self):
        return self.n_terms_train * 2 + 1

    def _kernel(self, p):
        return spectral_normalize(p["kernel"], p["u"], self.input_size,
                                  self.coeff)[0]

    def _series_forward(self, p, x, terms):
        kernel = self._kernel(p)
        x, ldj = self.conv1x1.forward_with(sub_params(p, "conv1x1"),
                                           x + p["pre_bias"])
        z = conv_exp(x, kernel, terms) + p["post_bias"]
        return z, ldj + conv_exp_logdet(kernel, x.shape[2], x.shape[3])

    def forward_with(self, p, x, generator=None):
        return self._series_forward(p, x, self.n_terms_train)

    def exact_forward_with(self, p, x):
        """13 terms instead of 6. The ldj is the same; the values differ
        by the series tail, at most about coeff^7/7! (1e-4 at coeff 0.9)
        of |x| per layer, and the layer adds no exact-ldj correction, so
        the cheap eval stays within that tail of the exact one."""
        return self._series_forward(p, x, self.n_terms_eval)

    def inverse_with(self, p, z, generator=None):
        x = conv_exp(z - p["post_bias"], -self._kernel(p), self.n_terms_eval)
        return self.conv1x1.inverse_with(sub_params(p, "conv1x1"),
                                         x) - p["pre_bias"]

    def _refresh(self, p, n_iter):
        p["u"].copy_(spectral_normalize(p["kernel"], p["u"], self.input_size,
                                        self.coeff, n_iter=n_iter)[1])

    @torch.no_grad()
    def data_init_with(self, p, x):
        """10 power iterations from the initial u."""
        self._refresh(p, 10)

    @torch.no_grad()
    def update_carry_with(self, p):
        """One power iteration from the carried u against the current
        kernel, so that sigma follows the weights through training."""
        self._refresh(p, 1)
