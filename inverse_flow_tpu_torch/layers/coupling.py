"""Affine coupling with the Glow-style zero-initialized conv net.

Port of ``inverse_flow_tpu/layers/coupling.py:Coupling``: net
conv3x3 -> ReLU -> conv1x1 -> ReLU -> Conv2dZero (zero init, ReZero
log-scale); ``log_s = 2*tanh(h/2)``; even/odd channel split of the net
output; the inverse runs the same net on the first half and undoes the
affine map. In float32 the net's first two convs and the ReLU between
them are :func:`~inverse_flow_tpu_torch.ops.coupling_net.
coupling_net_hidden`: one hand-written kernel on the card (its backward
another), the ``F.conv2d`` composition on the CPU. ``remat_net``
checkpoints the net (``torch.utils.checkpoint``, as ``jax.checkpoint`` in
the JAX layer): its activations are recomputed in the backward instead of
kept; the values are the same.
``compute_dtype="bfloat16"`` (or ``"bf16"``) runs the net's three convs in
bf16, as the JAX layer's mixed-precision policy: x1 and the three weights
are cast per call, the net's output is cast back to float32 before ``b3``
and the ReZero scale, and log_s, t, exp and the ldj stay float32.

Also ``BSplineCoupling`` (``coupling.py:131-205``): the second half goes
through a monotone cubic B-spline whose coefficients the first half's net
gives per element; its inverse is the net, one kernel launch on the card
(:func:`~inverse_flow_tpu_torch.ops.bspline.bspline_inverse`, which reads
the coefficients channel-major, as the net gives them, and the second half
where it lies, and does the maps and the tails) and the ``cat``.

Under a (data, model) mesh (:func:`~inverse_flow_tpu_torch.parallel.
apply_shardings`) a net holds this rank's slice of the width, ``w1``'s
output channels and ``w2``'s input channels, and its ``model_group``: its
input goes through :func:`~inverse_flow_tpu_torch.parallel.copy_to_model`
and ``w2``'s partial output through ``reduce_from_model``, so the net's
output and every gradient after it are those of the whole net. Without a
group the net is the one-device net.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import bspline
from ..ops.bspline import clip01, monotone_cubic_b_spline
from ..ops.coupling_net import coupling_net_hidden
from ..parallel.mesh import copy_to_model, reduce_from_model
from ..utils.profiling import span
from .base import FlowLayer, sum_except_batch


def net_dtype(name):
    """The torch dtype of a coupling net's ``compute_dtype``: float32, or
    bf16 for the JAX spellings ``"bfloat16"`` and ``"bf16"``."""
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unknown coupling compute_dtype {name!r}")


def _kaiming_uniform(shape, generator, device):
    """nn.Conv2d's default weight init (kaiming_uniform, a=sqrt(5))."""
    bound = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
    u = torch.rand(shape, generator=generator, device=device)
    return nn.Parameter((2 * u - 1) * bound)


class Coupling(FlowLayer):
    """Affine coupling on channel halves: the first C//2 channels of
    ``input_size`` (C, H, W) condition the transform of the rest."""

    #: the process group over which a sharded net sums (None: unsharded)
    model_group = None
    span_name = "ift.coupling"

    def __init__(self, input_size: Tuple[int, int, int], width: int = 512,
                 logscale_factor: float = 3.0, remat_net: bool = False,
                 compute_dtype: str = "float32", generator=None,
                 device=None):
        super().__init__()
        c = input_size[0]
        self.half_channels = c // 2
        self.logscale_factor = logscale_factor
        self.remat_net = remat_net
        self.compute_dtype = net_dtype(compute_dtype)
        self.w1 = _kaiming_uniform((width, c // 2, 3, 3), generator, device)
        self.w2 = _kaiming_uniform((c, width, 1, 1), generator, device)
        self.w3 = nn.Parameter(torch.zeros((c, c, 3, 3), device=device))
        self.b3 = nn.Parameter(torch.zeros((c,), device=device))
        self.logs3 = nn.Parameter(torch.zeros((c,), device=device))

    def _net(self, p, x1):
        with span("ift.coupling.net"):
            dt = self.compute_dtype         # .to(float32) returns its input
            group = self.model_group
            if group is not None:
                x1 = copy_to_model(x1, group)
            if dt == torch.float32:
                h = coupling_net_hidden(x1, p["w1"], p["w2"])
            else:
                h = F.relu(F.conv2d(x1.to(dt), p["w1"].to(dt), padding=1))
                h = F.conv2d(h, p["w2"].to(dt))
            if group is not None:
                h = reduce_from_model(h, group)
            h = F.relu(h)
            if dt == torch.float32:
                h = F.conv2d(h, p["w3"], p["b3"], padding=1)
            else:
                h = F.conv2d(h, p["w3"].to(dt), padding=1).float()
                h = h + p["b3"].reshape(1, -1, 1, 1)
            return h * torch.exp(p["logs3"] * self.logscale_factor).reshape(
                1, -1, 1, 1)

    def _split_logs_t(self, p, x):
        """(x1, x2, log_s, t): the halves and the affine map that x1's net
        gives the second half."""
        x1, x2 = x[:, :self.half_channels], x[:, self.half_channels:]
        if self.remat_net and torch.is_grad_enabled():
            # the net draws no random numbers: no RNG state to replay
            h = checkpoint(self._net, p, x1, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = self._net(p, x1)
        return x1, x2, 2.0 * torch.tanh(h[:, ::2] / 2.0), h[:, 1::2]

    def forward_with(self, p, x, generator=None):
        x1, x2, log_s, t = self._split_logs_t(p, x)
        z2 = x2 * torch.exp(log_s) + t
        return torch.cat([x1, z2], dim=1), sum_except_batch(log_s)

    def inverse_with(self, p, z, generator=None):
        x1, z2, log_s, t = self._split_logs_t(p, z)
        return torch.cat([x1, (z2 - t) * torch.exp(-log_s)], dim=1)


class BSplineCoupling(FlowLayer):
    """Coupling whose transform is a per-element monotone cubic B-spline:
    the first C//2 channels drive a conv net (conv3x3 -> ReLU -> conv1x1
    -> ReLU -> zero-initialized conv3x3, ReZero log-scale) that gives
    ``n_bins + 3`` spline coefficients for every element of the second
    half; ``[-tail_bound, tail_bound]`` is mapped onto [0, 1] and back,
    the identity outside. Zero init makes the spline the identity, so the
    layer starts as one."""

    #: the process group over which a sharded net sums (None: unsharded)
    model_group = None
    span_name = "ift.coupling"

    def __init__(self, input_size: Tuple[int, int, int], width: int = 512,
                 n_bins: int = 8, tail_bound: float = 10.0,
                 logscale_factor: float = 3.0, generator=None, device=None):
        super().__init__()
        c = input_size[0]
        self.half_channels = c // 2
        self.n_bins = n_bins
        self.tail_bound = tail_bound
        self.logscale_factor = logscale_factor
        n_out = (c - c // 2) * (n_bins + 3)
        self.w1 = _kaiming_uniform((width, c // 2, 3, 3), generator, device)
        self.w2 = _kaiming_uniform((width, width, 1, 1), generator, device)
        self.w3 = nn.Parameter(torch.zeros((n_out, width, 3, 3),
                                           device=device))
        self.b3 = nn.Parameter(torch.zeros((n_out,), device=device))
        self.logs3 = nn.Parameter(torch.zeros((n_out,), device=device))

    def _net(self, p, x1):
        """(B, (C - C//2) * (n_bins + 3), H, W) spline coefficients,
        channel-major: coefficient k of channel c at c * (n_bins + 3) + k."""
        group = self.model_group
        if group is not None:
            x1 = copy_to_model(x1, group)
        h = F.relu(F.conv2d(x1, p["w1"], padding=1))
        h = F.conv2d(h, p["w2"])
        if group is not None:
            h = reduce_from_model(h, group)
        h = F.relu(h)
        h = F.conv2d(h, p["w3"], p["b3"], padding=1)
        return h * torch.exp(p["logs3"] * self.logscale_factor).reshape(
            1, -1, 1, 1)

    def forward_with(self, p, x, generator=None):
        x1, x2 = x[:, :self.half_channels], x[:, self.half_channels:]
        tb = self.tail_bound
        inside = (x2 > -tb) & (x2 < tb)
        u = clip01((x2 + tb) / (2 * tb))
        h = self._net(p, x1)
        b, _, hh, ww = h.shape
        coeffs = h.reshape(b, -1, self.n_bins + 3, hh, ww).permute(
            0, 1, 3, 4, 2)
        out, ld = monotone_cubic_b_spline(u, coeffs)
        z2 = torch.where(inside, out * 2 * tb - tb, x2)
        return (torch.cat([x1, z2], dim=1),
                sum_except_batch(torch.where(inside, ld, 0.0)))

    def inverse_with(self, p, z, generator=None):
        z1, z2 = z[:, :self.half_channels], z[:, self.half_channels:]
        tb = self.tail_bound
        x2 = bspline.bspline_inverse(
            z2, self._net(p, z1), "channels", interval=(-tb, tb),
            out_interval=(-tb, tb), tails=True, logdet=False)[0]
        return torch.cat([z1, x2], dim=1)
