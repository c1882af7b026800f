"""Elementwise invertible activations.

Port of ``inverse_flow_tpu/layers/activations.py``: the base
``FlowActivationLayer`` (ldj ``sum log|f'(x)|``, a Newton inverse), the
smooth leaky ReLU, the leaky ReLU and its learnable form, the smooth tanh,
the RQ-spline activation (one knot set per tensor position, or one global
set), the monotone cubic B-spline activation and the identity, both
directions each.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import bspline
from ..ops.activations import (slr, slr_inverse, slr_prime, smooth_tanh,
                               smooth_tanh_inverse, smooth_tanh_prime)
from ..ops.bspline import clip01, monotone_cubic_b_spline
from .base import FlowLayer, sum_except_batch
from .splines import unconstrained_rational_quadratic_spline


class FlowActivationLayer(FlowLayer):
    """Elementwise ``activation(p, x)`` with ldj ``sum log|act_prime(p,
    x)|``. JAX's fixed Newton inverse (``x <- x - (f(x) - y) / max(f'(x),
    1e-2)`` from x = y, 100 steps) is, for SmoothLeakyRelu and
    SmoothTanh, one kernel launch on the card and a plain loop on the CPU
    (``ops/activations.py``)."""

    span_name = "ift.act"

    def activation(self, p, x):
        raise NotImplementedError

    def act_prime(self, p, x):
        raise NotImplementedError

    def forward_with(self, p, x, generator=None):
        return self.activation(p, x), sum_except_batch(
            torch.log(torch.abs(self.act_prime(p, x))))


class SmoothLeakyRelu(FlowActivationLayer):
    """``alpha*x + (1-alpha)*softplus(x)``; ldj ``sum log(alpha +
    (1-alpha)*sigmoid(x))``. softplus is ``logaddexp(x, 0)``, the JAX
    formula, with no threshold (``F.softplus`` returns x above 20). The
    inverse is JAX's 100-step Newton loop, one kernel launch on the card
    (:func:`~inverse_flow_tpu_torch.ops.activations.slr_inverse`)."""

    def __init__(self, alpha: float = 0.3):
        super().__init__()
        self.alpha = alpha

    def activation(self, p, x):
        return slr(x, self.alpha)

    def act_prime(self, p, x):
        return slr_prime(x, self.alpha)

    def inverse_with(self, p, z, generator=None):
        return slr_inverse(z, self.alpha)


class LeakyRelu(FlowActivationLayer):
    """``alpha*x`` below 0, ``x`` above; the inverse in closed form."""

    def __init__(self, alpha: float = 0.1):
        super().__init__()
        self.alpha = alpha

    def activation(self, p, x):
        return torch.where(x < 0, self.alpha * x, x)

    def act_prime(self, p, x):
        return torch.where(x < 0, self.alpha, 1.0)

    def inverse_with(self, p, z, generator=None):
        return torch.where(z < 0, z / self.alpha, z)


class LearnableLeakyRelu(FlowActivationLayer):
    """The leaky ReLU with the learnable slope ``sigmoid(alpha_logit) +
    0.5`` (param ``alpha_logit`` (1,), zero at init)."""

    def __init__(self, device=None):
        super().__init__()
        self.alpha_logit = nn.Parameter(torch.zeros((1,), device=device))

    def _alpha(self, p):
        return torch.sigmoid(p["alpha_logit"]) + 0.5

    def activation(self, p, x):
        return torch.where(x < 0, self._alpha(p) * x, x)

    def act_prime(self, p, x):
        a = self._alpha(p)
        return torch.where(x < 0, a, torch.ones_like(a))

    def inverse_with(self, p, z, generator=None):
        return torch.where(z < 0, z / self._alpha(p), z)


class SmoothTanh(FlowActivationLayer):
    """``tanh(alpha*x) + beta*x``; the inverse is JAX's 100-step Newton
    loop, one kernel launch on the card
    (:func:`~inverse_flow_tpu_torch.ops.activations.smooth_tanh_inverse`)."""

    def __init__(self, alpha: float = 1.0, beta: float = 0.1):
        super().__init__()
        self.alpha = alpha
        self.beta = beta

    def activation(self, p, x):
        return smooth_tanh(x, self.alpha, self.beta)

    def act_prime(self, p, x):
        return smooth_tanh_prime(x, self.alpha, self.beta)

    def inverse_with(self, p, z, generator=None):
        return smooth_tanh_inverse(z, self.alpha, self.beta)


class Identity(FlowActivationLayer):

    def activation(self, p, x):
        return x

    def act_prime(self, p, x):
        return torch.ones_like(x)

    def inverse_with(self, p, z, generator=None):
        return z


class SplineActivation(FlowLayer):
    """Elementwise RQ spline with learned knots: with
    ``individual_weights`` (the port's default, the flagship's setting;
    JAX's default is the global form) one knot set per tensor position,
    shape (1, *input_size, n_bins), shared over the batch; else one
    global set of shape (n_bins,). JAX's ``tile_params`` only chose how
    the TPU compiler saw the same numbers, so the port keeps one form."""

    span_name = "ift.act"

    def __init__(self, input_size: Tuple[int, ...], n_bins: int = 5,
                 tail_bound: float = 10.0, individual_weights: bool = True,
                 generator=None, device=None):
        super().__init__()
        self.tail_bound = tail_bound
        lead = (1,) + tuple(input_size) if individual_weights else ()

        def noise(shape):
            return nn.Parameter(0.01 * torch.randn(
                shape, generator=generator, device=device))

        self.widths = noise(lead + (n_bins,))
        self.heights = noise(lead + (n_bins,))
        self.derivs = noise(lead + (n_bins - 1,))

    def _knots(self, p, x):
        """The knot parameters, broadcastable against ``x[..., None]``."""
        if p["widths"].ndim > 1:
            return p["widths"], p["heights"], p["derivs"]
        ones = (1,) * x.ndim
        return tuple(p[k].reshape(ones + (-1,))
                     for k in ("widths", "heights", "derivs"))

    def forward_with(self, p, x, generator=None):
        out, ld = unconstrained_rational_quadratic_spline(
            x, *self._knots(p, x), tail_bound=self.tail_bound)
        return out, sum_except_batch(ld)

    def inverse_with(self, p, z, generator=None):
        return unconstrained_rational_quadratic_spline(
            z, *self._knots(p, z), inverse=True,
            tail_bound=self.tail_bound)[0]


class BSplineActivation(FlowLayer):
    """Elementwise monotone cubic B-spline (param ``coeffs``, n_bins + 3):
    ``[-tail_bound, tail_bound]`` mapped affinely onto [0, 1], through the
    spline and back; the identity with ldj 0 outside. The inverse, maps
    and tails included, is one kernel launch on the card
    (:func:`~inverse_flow_tpu_torch.ops.bspline.bspline_inverse`, the
    coefficients shared by every element)."""

    span_name = "ift.act"

    def __init__(self, n_bins: int = 8, tail_bound: float = 10.0,
                 generator=None, device=None):
        super().__init__()
        self.tail_bound = tail_bound
        self.coeffs = nn.Parameter(0.01 * torch.randn(
            (n_bins + 3,), generator=generator, device=device))

    def forward_with(self, p, x, generator=None):
        b = self.tail_bound
        inside = (x > -b) & (x < b)
        u = clip01((x + b) / (2 * b))
        out, ld = monotone_cubic_b_spline(u, p["coeffs"])
        y = torch.where(inside, out * 2 * b - b, x)
        return y, sum_except_batch(torch.where(inside, ld, 0.0))

    def inverse_with(self, p, z, generator=None):
        b = self.tail_bound
        return bspline.bspline_inverse(
            z, p["coeffs"], "shared", interval=(-b, b), out_interval=(-b, b),
            tails=True, logdet=False)[0]
