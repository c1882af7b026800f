"""Self-normalizing convolutions with the modified gradient.

Port of ``inverse_flow_tpu/layers/selfnorm.py``. The layer keeps twin
kernels, the forward ``w`` and the approximate inverse ``r``. The cheap
forward is a conv with ldj 0 whose backward is the self-normalizing
gradient (:class:`SelfNormConv2d`, the JAX ``custom_vjp`` ``_sn_bwd``):

    grad_w = (wgrad(g, x) - flip(r) * multiple) / 2
    grad_r = (wgrad(-dx, Wx) + flip(w) * flip(multiple)) / 2

``flip`` is the spatial flip with the in/out channels swapped and
``multiple`` the number of products behind each tap per sample (the
weight gradient of ones, over the batch). The exact path takes the
log-determinant and the inverse of the dense conv operator
(``ops/toeplitz.py``); the layer-local reconstruction loss ``|x - R W x|^2``
(and its symmetric form) joins the training loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..ops.convs import conv2d, conv2d_input_grad, conv2d_weight_grad
from ..ops.toeplitz import conv_exact_inverse, conv_logdet
from .base import FlowLayer, sum_except_batch, zeros_ldj


def flip_kernel(w):
    """Spatial flip and in/out channel transpose."""
    return w.flip((2, 3)).transpose(0, 1)


class SelfNormConv2d(torch.autograd.Function):
    """``z = conv(x, w) + b`` whose backward is the self-normalizing
    gradient: the port of the JAX ``_sn_fwd``/``_sn_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, r, stride, padding):
        z = conv2d(x, w, stride=stride, padding=padding)
        if b is not None:
            z = z + b.reshape(1, -1, 1, 1)
        ctx.stride, ctx.padding, ctx.has_bias = stride, padding, b is not None
        ctx.save_for_backward(x, w, r, z if b is None else z - b.reshape(
            1, -1, 1, 1))
        return z

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, r, wx = ctx.saved_tensors
        conv = dict(stride=ctx.stride, padding=ctx.padding)
        multiple = conv2d_weight_grad(torch.ones_like(wx),
                                      torch.ones_like(x), w.shape,
                                      **conv) / x.shape[0]
        grad_w = (conv2d_weight_grad(g, x, w.shape, **conv)
                  - flip_kernel(r) * multiple) / 2.0
        grad_x = conv2d_input_grad(g, w, x.shape, **conv)
        grad_r = (conv2d_weight_grad(-grad_x, wx, r.shape, **conv)
                  + flip_kernel(w) * flip_kernel(multiple)) / 2.0
        grad_b = g.sum((0, 2, 3)) if ctx.has_bias else None
        return grad_x, grad_w, grad_b, grad_r, None, None


def selfnorm_conv2d(x, w, b, r, stride=1, padding=0):
    """The forward conv with the self-normalizing gradient."""
    return SelfNormConv2d.apply(x, w, b, r, stride, padding)


def _xavier_std(w_shape, gain=0.01):
    c_out, c_in, kh, kw = w_shape
    return gain * (2.0 / (c_in * kh * kw + c_out * kh * kw)) ** 0.5


def _dirac_noise_init(w_shape, generator, device):
    """Xavier noise with the identity added at the spatial centre of the
    square channel block."""
    c_out, c_in, kh, kw = w_shape
    w = _xavier_std(w_shape) * torch.randn(w_shape, generator=generator,
                                           device=device)
    sq = min(c_out, c_in)
    w[:sq, :sq, kh // 2, kw // 2] += torch.eye(sq, device=device)
    return w


def _orthogonal_1x1_init(w_shape, generator, device):
    """Q of the reduced QR of a Gaussian (c_out, c_in) matrix: the 1x1
    layer starts as a random rotation (c_out >= c_in)."""
    a = torch.randn(w_shape[:2], generator=generator, device=device)
    return torch.linalg.qr(a)[0].reshape(w_shape)


class SelfNormConv(FlowLayer):
    """Self-normalizing conv; params ``w`` (out, in, KH, KW), ``r`` (in,
    out, KH, KW), ``b`` (out,) when ``bias``. The cheap forward has ldj 0
    and the modified gradient; the cheap inverse is the conv with ``r``."""

    has_modified_grad = True
    has_recon_loss = True

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (1, 1), bias: bool = True,
                 stride: int = 1, padding: int = 0, generator=None,
                 device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = tuple(kernel_size)
        self.stride, self.padding = stride, padding
        w_shape = (out_channels, in_channels) + self.kernel_size
        w = self._init_w(w_shape, generator, device)
        self.w = torch.nn.Parameter(w)
        self.r = torch.nn.Parameter(flip_kernel(w).contiguous())
        self.b = torch.nn.Parameter(_xavier_std(w_shape) * torch.randn(
            (out_channels,), generator=generator, device=device)) \
            if bias else None

    def _init_w(self, w_shape, generator, device):
        if self.kernel_size == (1, 1) and w_shape[0] >= w_shape[1]:
            return _orthogonal_1x1_init(w_shape, generator, device)
        return _dirac_noise_init(w_shape, generator, device)

    def out_shape(self, shape):
        c, h, w = shape
        kh, kw = self.kernel_size
        return (self.out_channels,
                (h + 2 * self.padding - kh) // self.stride + 1,
                (w + 2 * self.padding - kw) // self.stride + 1)

    def _conv(self, x, w):
        return conv2d(x, w, stride=self.stride, padding=self.padding)

    def forward_with(self, p, x, generator=None):
        z = selfnorm_conv2d(x, p["w"], p.get("b"), p["r"], self.stride,
                            self.padding)
        return z, zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        if "b" in p:
            z = z - p["b"].reshape(1, -1, 1, 1)
        return self._conv(z, p["r"])

    def exact_forward_with(self, p, x):
        z = self._conv(x, p["w"])
        if "b" in p:
            z = z + p["b"].reshape(1, -1, 1, 1)
        ld = conv_logdet(p["w"], x.shape[1:], self.stride, self.padding)
        return z, ld.expand(x.shape[0])

    def exact_inverse_with(self, p, z):
        if self.stride != 1:
            raise NotImplementedError(
                "SelfNormConv.exact_inverse supports stride=1 only: a "
                "strided conv's dense operator is not square. Use the "
                "approximate inverse() instead.")
        if "b" in p:
            z = z - p["b"].reshape(1, -1, 1, 1)
        kh, kw = self.kernel_size
        in_shape = (self.in_channels, z.shape[2] + kh - 1 - 2 * self.padding,
                    z.shape[3] + kw - 1 - 2 * self.padding)
        return conv_exact_inverse(z, p["w"], in_shape, 1, self.padding)

    def exact_ldj_correction_with(self, p, in_shape):
        """The cheap ldj is 0, so the correction is the exact logdet."""
        return conv_logdet(p["w"], tuple(in_shape), self.stride,
                           self.padding)

    def recon_loss_with(self, p, x, sym=False, only_R=False):
        """``|x - R W x|^2`` per sample (``only_R``: W x detached);
        ``sym`` averages it with ``|z - W R z|^2``, z = W x detached."""
        z = self._conv(x, p["w"])
        if only_R:
            z = z.detach()
        loss = sum_except_batch((x - self._conv(z, p["r"])) ** 2)
        if sym:
            z_hat = self._conv(self._conv(z, p["r"]), p["w"])
            loss = (loss + sum_except_batch((z.detach() - z_hat) ** 2)) / 2.0
        return loss


class SelfNormFC(SelfNormConv):
    """The 1x1 layer over flat (B, in) inputs, with its own init: the
    square channel block set to the identity inside Xavier noise."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, generator=None, device=None):
        super().__init__(in_channels, out_channels, (1, 1), bias=bias,
                         generator=generator, device=device)

    def _init_w(self, w_shape, generator, device):
        w = _xavier_std(w_shape) * torch.randn(w_shape, generator=generator,
                                               device=device)
        sq = min(w_shape[0], w_shape[1])
        w[:sq, :sq, 0, 0] = torch.eye(sq, device=device)
        return w

    def out_shape(self, shape):
        return (self.out_channels,)

    def _to4d(self, x, c):
        return x.reshape(-1, c, 1, 1)

    def forward_with(self, p, x, generator=None):
        z, ldj = super().forward_with(p, self._to4d(x, self.in_channels))
        return z.reshape(-1, self.out_channels), ldj

    def inverse_with(self, p, z, generator=None):
        x = super().inverse_with(p, self._to4d(z, self.out_channels))
        return x.reshape(-1, self.in_channels)

    def _logdet(self, p):
        if self.in_channels == self.out_channels:
            return torch.linalg.slogdet(p["w"][:, :, 0, 0])[1]
        return torch.zeros((), device=p["w"].device)

    def exact_forward_with(self, p, x):
        z = conv2d(self._to4d(x, self.in_channels), p["w"])
        if "b" in p:
            z = z + p["b"].reshape(1, -1, 1, 1)
        return (z.reshape(-1, self.out_channels),
                self._logdet(p).expand(x.shape[0]))

    def exact_inverse_with(self, p, z):
        if "b" in p:
            z = z - p["b"]
        return z.reshape(-1, self.out_channels) @ torch.linalg.inv(
            p["w"][:, :, 0, 0]).T

    def exact_ldj_correction_with(self, p, in_shape):
        return self._logdet(p)

    def recon_loss_with(self, p, x, sym=False, only_R=False):
        return super().recon_loss_with(p, self._to4d(x, self.in_channels),
                                       sym=sym, only_R=only_R)
