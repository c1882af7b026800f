"""Elementwise activations: the RQ spline and the smooth leaky ReLU.

Port of ``inverse_flow_tpu/layers/activations.py``: ``SplineActivation``
with ``individual_weights=True``, the flagship's setting (one knot set per
tensor position, shared over the batch), and ``SmoothLeakyRelu``, both
directions each.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.activations import slr, slr_inverse, slr_prime
from .base import FlowLayer, sum_except_batch
from .splines import unconstrained_rational_quadratic_spline


class SplineActivation(FlowLayer):

    def __init__(self, input_size: Tuple[int, ...], n_bins: int = 5,
                 tail_bound: float = 10.0, generator=None, device=None):
        super().__init__()
        self.tail_bound = tail_bound
        wshape = (1,) + tuple(input_size) + (n_bins,)
        dshape = (1,) + tuple(input_size) + (n_bins - 1,)

        def noise(shape):
            return nn.Parameter(0.01 * torch.randn(
                shape, generator=generator, device=device))

        self.widths = noise(wshape)
        self.heights = noise(wshape)
        self.derivs = noise(dshape)

    def forward_with(self, p, x, generator=None):
        out, ld = unconstrained_rational_quadratic_spline(
            x, p["widths"], p["heights"], p["derivs"],
            tail_bound=self.tail_bound)
        return out, sum_except_batch(ld)

    def inverse_with(self, p, z, generator=None):
        return unconstrained_rational_quadratic_spline(
            z, p["widths"], p["heights"], p["derivs"], inverse=True,
            tail_bound=self.tail_bound)[0]


class SmoothLeakyRelu(FlowLayer):
    """``alpha*x + (1-alpha)*softplus(x)``; ldj ``sum log(alpha +
    (1-alpha)*sigmoid(x))``. softplus is ``logaddexp(x, 0)``, the JAX
    formula, with no threshold (``F.softplus`` returns x above 20). The
    inverse is JAX's 100-step Newton loop, one kernel launch on the card
    (:func:`~inverse_flow_tpu_torch.ops.activations.slr_inverse`)."""

    def __init__(self, alpha: float = 0.3):
        super().__init__()
        self.alpha = alpha

    def forward_with(self, p, x, generator=None):
        return (slr(x, self.alpha),
                sum_except_batch(torch.log(slr_prime(x, self.alpha))))

    def inverse_with(self, p, z, generator=None):
        return slr_inverse(z, self.alpha)
