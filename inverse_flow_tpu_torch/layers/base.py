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
  * ``exact_forward_with(p, x)`` and ``exact_inverse_with(p, z)``: the
    exact-logdet forward and the exact inverse (SelfNorm's dense slogdet
    and solve); the cheap pair by default. ``has_exact_path`` says whether
    a layer's differ.
  * ``exact_ldj_correction_with(p, in_shape)``: exact minus cheap ldj for
    one sample, from the parameters alone (a 0-d zero by default), so
    that eval computes the dense slogdets once per epoch.
  * ``recon_loss_with(p, x, sym, only_R)``: the layer-local reconstruction
    loss, (B,) (zeros by default; SelfNorm's when ``has_recon_loss``).
  * ``out_shape(shape)``: the output shape (no batch) for an input shape.
  * ``update_carry_with(p)``: for a layer that ``has_carry`` (ConvExp),
    refresh in place the non-learnable state it keeps among its
    parameters, against the parameters' current values; the trainer calls
    it after every optimizer step. Such state is a parameter with
    ``requires_grad=False``: the optimizer and the weight clamp leave it
    alone (the JAX ``carry_mask``), and the bridge and the checkpoints
    carry it as any other.
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
    #: layers whose cheap-path gradient is modified and whose exact path
    #: differs (SelfNorm)
    has_modified_grad: bool = False
    #: layers whose reconstruction loss joins the training loss
    has_recon_loss: bool = False
    #: layers that carry non-learnable state among their parameters
    has_carry: bool = False
    #: the span (``utils/profiling.SPANS``) that the layer loops of
    #: ``Flow`` and ``RepeatedBlock`` open around the layer's call; None
    #: for none
    span_name = None

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

    def update_carry_with(self, p):
        """Refresh the carried state in ``p`` in place; a no-op by
        default."""
        del p

    def update_carry(self):
        self.update_carry_with(self.own_params())

    def out_shape(self, shape):
        """The output shape (no batch dim) for input ``shape``."""
        return tuple(shape)

    # --- exact paths and the reconstruction loss -------------------------
    def exact_forward_with(self, p, x):
        return self.forward_with(p, x)

    def exact_inverse_with(self, p, z):
        return self.inverse_with(p, z)

    def exact_forward(self, x):
        return self.exact_forward_with(self.own_params(), x)

    def exact_inverse(self, z):
        return self.exact_inverse_with(self.own_params(), z)

    @property
    def has_exact_path(self):
        """True when ``exact_forward_with``/``exact_inverse_with`` differ
        from the cheap pair: the gate of ``Flow.forward(exact=True)``."""
        cls = type(self)
        return (self.has_modified_grad
                or cls.exact_forward_with is not FlowLayer.exact_forward_with
                or cls.exact_inverse_with is not FlowLayer.exact_inverse_with)

    def exact_ldj_correction_with(self, p, in_shape):
        """Exact minus cheap ldj for one sample of shape ``in_shape``; 0."""
        del in_shape
        device = next(iter(p.values())).device if p else None
        return torch.zeros((), dtype=torch.float32, device=device)

    def recon_loss_with(self, p, x, sym=False, only_R=False):
        """Layer-local reconstruction loss, (B,); zeros by default."""
        del p, sym, only_R
        return zeros_ldj(x)


def sub_params(p, prefix):
    """The entries of ``p`` under ``prefix`` (``"t.1"``), with the prefix
    and its dot taken off: a child module's parameter dict."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in p.items() if k.startswith(head)}
