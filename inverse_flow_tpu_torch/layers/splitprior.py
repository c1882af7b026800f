"""SplitPrior: coupling, then factor out half the channels under a
standard normal whose log-prob joins the layer's ldj.

Port of ``inverse_flow_tpu/layers/splitprior.py:SplitPrior``: the inverse
draws the factored-out half from that normal, concatenates it and inverts
the coupling. Its parameters are the coupling's, under the same names, and
``compute_dtype`` is the coupling net's.
``SplitPriorFC`` is the same on flat inputs, ``input_size`` being (n, 1,
1).
"""

from __future__ import annotations

import torch

from ..distributions import GaussianPrior
from .coupling import Coupling


class SplitPrior(Coupling):

    span_name = "ift.prior"

    def __init__(self, input_size, width: int = 512, remat_net: bool = False,
                 compute_dtype: str = "float32", generator=None, device=None):
        super().__init__(input_size, width=width, remat_net=remat_net,
                         compute_dtype=compute_dtype, generator=generator,
                         device=device)
        c, h, w = input_size
        self.base = GaussianPrior((c // 2, h, w))

    def out_shape(self, shape):
        return tuple(self.base.size)

    def forward_with(self, p, x, generator=None):
        z, ldj = super().forward_with(p, x)
        c_half = z.shape[1] // 2
        return z[:, :c_half], self.base.log_prob(z[:, c_half:]) + ldj

    def inverse_with(self, p, z, generator=None, noise=None):
        """The factored-out half is drawn from the base with
        ``generator`` on z's device, or given as ``noise``."""
        if noise is None:
            if generator is None:
                raise ValueError(
                    "SplitPrior.inverse needs a generator or noise")
            noise, _ = self.base.sample(generator, z.shape[0],
                                        device=z.device)
        return super().inverse_with(p, torch.cat([z, noise], dim=1))

    def inverse(self, z, generator=None, noise=None):
        return self.inverse_with(self.own_params(), z, generator, noise)


class SplitPriorFC(SplitPrior):
    """SplitPrior on flat (B, n) inputs, as (B, n, 1, 1); the output is
    (B, n // 2)."""

    def out_shape(self, shape):
        return (shape[0] // 2,)

    def forward_with(self, p, x, generator=None):
        n = self.half_channels * 2
        out, ldj = super().forward_with(p, x.reshape(-1, n, 1, 1))
        return out.reshape(-1, n // 2), ldj

    def inverse_with(self, p, z, generator=None, noise=None):
        n = self.half_channels * 2
        return super().inverse_with(p, z.reshape(-1, n // 2, 1, 1),
                                    generator, noise).reshape(-1, n)
