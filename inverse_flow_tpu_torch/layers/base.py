"""Invertible-layer contract of the PyTorch port.

Port of ``inverse_flow_tpu/layers/base.py``. A layer is an ``nn.Module``
whose parameters carry the names of the JAX params pytree:

  * ``forward(x, generator=None) -> (z, ldj)``: training direction; ``ldj``
    is always a ``(B,)`` float32 tensor. ``generator`` is the
    ``torch.Generator`` a stochastic layer draws from.
  * ``forward_with(p, x, generator=None)``: the same with the parameters
    given as a dict of tensors under their dotted names (a child module's
    as ``convs.0.w``). ``RepeatedBlock`` keeps its K steps' parameters
    stacked and runs step k on the k-th slices.
  * ``inverse(z, generator=None) -> x`` and ``inverse_with(p, z,
    generator=None)``: the sampling direction, mirroring ``forward`` and
    ``forward_with``; a layer without one raises ``NotImplementedError``.
  * ``data_init_with(p, x)``: data-dependent initialisation, written in
    place into ``p`` (ActNorm); a no-op by default.
"""

from __future__ import annotations

import torch
from torch import nn


def sum_except_batch(x):
    """Sum all axes except the leading batch axis. Returns shape (B,)."""
    return x.reshape(x.shape[0], -1).sum(-1)


def zeros_ldj(x):
    """A (B,) zero log-det contribution matching x's batch size."""
    return torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


class FlowLayer(nn.Module):
    """Base invertible layer."""

    #: marks layers of the preprocessing group
    is_preprocessing: bool = False
    #: layers whose reconstruction loss joins the training loss (none
    #: ported yet: ``Experiment.train_step`` raises on one)
    has_recon_loss: bool = False

    def own_params(self):
        """The layer's parameters, its child modules' included, by dotted
        name: the dict ``forward_with`` reads."""
        return dict(self.named_parameters())

    def forward(self, x, generator=None):
        return self.forward_with(self.own_params(), x, generator)

    def forward_with(self, p, x, generator=None):
        raise NotImplementedError

    def inverse(self, z, generator=None):
        return self.inverse_with(self.own_params(), z, generator)

    def inverse_with(self, p, z, generator=None):
        raise NotImplementedError(
            f"{type(self).__name__}.inverse is not ported")

    def data_init_with(self, p, x):
        """Data-dependent init, in place on ``p``; default is a no-op."""
        del p, x

    def data_init(self, x):
        self.data_init_with(self.own_params(), x)
