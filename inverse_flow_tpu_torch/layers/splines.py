"""Unconstrained rational-quadratic splines (Durkan et al.) and the
monotone cubic B-spline with its conditional transformer.

Port of ``inverse_flow_tpu/layers/splines.py``, both directions. The bin
parameters are computed at their own shape and broadcast to the inputs
only where a bin is selected (``torch.gather``; JAX contracts a one-hot,
a TPU workaround that gives the same values). The monotone cubic
B-spline itself lives in ``ops/bspline.py`` (re-exported here); the
transformer's inverse is one launch of its kernel on the card
(:func:`~inverse_flow_tpu_torch.ops.bspline.bspline_inverse`, the
coefficients in the last dim).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import bspline
from ..ops.bspline import clip01, monotone_cubic_b_spline

__all__ = ["ConditionalBSplineTransformer", "clip01",
           "monotone_cubic_b_spline", "rational_quadratic_spline",
           "unconstrained_rational_quadratic_spline"]

DEFAULT_MIN_BIN_WIDTH = 1e-6
DEFAULT_MIN_BIN_HEIGHT = 1e-6
DEFAULT_MIN_DERIVATIVE = 1e-6


def _searchsorted(bin_locations, inputs, eps=1e-6):
    """Bin index of each input; eps on the last edge keeps an input equal
    to the right bound in the last bin (a bare ``torch.searchsorted``
    differs there)."""
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).sum(-1) - 1


def unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tail_bound=1.0,
        min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Identity tails outside [-tail_bound, tail_bound]; RQ spline inside
    (its inverse when ``inverse``). Returns (outputs, logabsdet)
    elementwise."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # boundary derivatives padded so softplus(c) + min_derivative == 1:
    # slope-1 tails, C1 at the bounds
    constant = math.log(math.expm1(1.0 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1)) \
        + constant
    clamped = inputs.clamp(-tail_bound, tail_bound)
    out_in, ldj_in = rational_quadratic_spline(
        clamped, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, left=-tail_bound,
        right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return (torch.where(inside, out_in, inputs),
            torch.where(inside, ldj_in, 0.0))


def _knots(unnormalized, num_bins, lo, hi, min_bin):
    """(bin sizes, cumulative knots) from unnormalized bin logits."""
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum[..., 0] = lo
    cum[..., -1] = hi
    return cum[..., 1:] - cum[..., :-1], cum


def rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, left=0.0, right=1.0,
        bottom=0.0, top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """RQ spline on [left, right] -> [bottom, top], or its inverse. The bin
    parameters broadcast against ``inputs[..., None]``."""
    num_bins = unnormalized_widths.shape[-1]
    widths, cumwidths = _knots(unnormalized_widths, num_bins, left, right,
                               min_bin_width)
    heights, cumheights = _knots(unnormalized_heights, num_bins, bottom, top,
                                 min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)
    delta = heights / widths

    lead = inputs.shape
    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def gather(t):
        return torch.gather(t.expand(lead + t.shape[-1:]), -1, bin_idx)[..., 0]

    input_cumwidths = gather(cumwidths[..., :-1])
    input_bin_widths = gather(widths)
    input_cumheights = gather(cumheights[..., :-1])
    input_delta = gather(delta)
    input_derivatives = gather(derivatives[..., :-1])
    input_derivatives_plus_one = gather(derivatives[..., 1:])
    input_heights = gather(heights)
    d_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        # the root of the bin's quadratic in theta, in the form that stays
        # accurate where a -> 0; the discriminant clamped at 0 as in JAX
        dy = inputs - input_cumheights
        a = dy * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - dy * d_sum
        c = -input_delta * dy
        discriminant = (b * b - 4 * a * c).clamp_min(0.0)
        theta = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = theta * input_bin_widths + input_cumwidths
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    if not inverse:
        numerator = input_heights * (input_delta * theta ** 2
                                     + input_derivatives
                                     * theta_one_minus_theta)
        outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, (-logabsdet if inverse else logabsdet)


class ConditionalBSplineTransformer:
    """A monotone cubic B-spline bijection of ``[left, right)`` onto
    ``[bottom, top)``, elementwise, conditioned on a network output: the
    caller owns the network and passes its output ``net_out``, whose last
    dim is ``y_dim * (n_bins + 3)``."""

    def __init__(self, y_dim, n_bins=8, left=0.0, right=1.0, bottom=0.0,
                 top=1.0):
        self.y_dim = y_dim
        self.n_bins = n_bins
        self.left, self.right = left, right
        self.bottom, self.top = bottom, top

    @property
    def params_per_dim(self):
        return self.n_bins + 3

    def _coeffs(self, net_out):
        return net_out.reshape(net_out.shape[:-1]
                               + (self.y_dim, self.params_per_dim))

    def forward(self, net_out, y):
        """(z, elementwise ldj)."""
        lo, hi, out_lo, out_hi = self.left, self.right, self.bottom, self.top
        out, ld = monotone_cubic_b_spline((y - lo) / (hi - lo),
                                          self._coeffs(net_out))
        return (out * (out_hi - out_lo) + out_lo,
                ld + math.log((out_hi - out_lo) / (hi - lo)))

    def inverse(self, net_out, z):
        """(y, elementwise ldj of the inverse): the maps in the kernel's
        launch on the card, then the constant log term."""
        lo, hi, out_lo, out_hi = self.bottom, self.top, self.left, self.right
        out, ld = bspline.bspline_inverse(z, self._coeffs(net_out), "last",
                                          interval=(lo, hi),
                                          out_interval=(out_lo, out_hi))
        return out, ld + math.log((out_hi - out_lo) / (hi - lo))
