"""Flow composition: layers, then the base distribution.

Port of ``inverse_flow_tpu/layers/sequential.py:Flow`` (forward,
``forward_verbose``, ``cheap_log_prob``, ``exact_ldj_correction``,
``recon_loss``, ``data_init``, ``update_carry``, ``sample``,
``reconstruct``, ``plot_filters``). The ldj of
each layer is added once. ``exact=True`` takes each layer's exact path
where it has one (SelfNorm's dense slogdet and solve); the exact log-prob
is the cheap one plus :meth:`Flow.exact_ldj_correction`, which depends on
the parameters alone.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.profiling import span
from .base import FlowLayer


class Flow(nn.Module):
    """A sequence of invertible layers with a base distribution."""

    def __init__(self, base_distribution, layers: Sequence[FlowLayer]):
        super().__init__()
        self.base_distribution = base_distribution
        self.layers = nn.ModuleList(layers)

    def forward(self, x, generator=None, exact=False):
        """Run all layers; returns (z, log_px), log_px including the base
        log-prob. ``exact``: each layer's exact path where it has one."""
        logdet = torch.zeros((x.shape[0],), device=x.device)
        for layer in self.layers:
            with span(layer.span_name):
                if exact and layer.has_exact_path:
                    x, ldj = layer.exact_forward(x)
                else:
                    x, ldj = layer(x, generator)
            logdet = logdet + ldj
        return x, self.base_distribution.log_prob(x) + logdet

    def forward_verbose(self, x, generator=None):
        """:meth:`forward` that also returns each layer's mean ldj under
        the JAX keys ``f"{i:02d}_{type(layer).__name__}"``: (z, log_px,
        {key: 0-d tensor})."""
        logdet = torch.zeros((x.shape[0],), device=x.device)
        per_layer = {}
        for i, layer in enumerate(self.layers):
            x, ldj = layer(x, generator)
            logdet = logdet + ldj
            per_layer[f"{i:02d}_{type(layer).__name__}"] = ldj.mean()
        return x, self.base_distribution.log_prob(x) + logdet, per_layer

    def cheap_log_prob(self, x, generator=None):
        return self.forward(x, generator)[1]

    @torch.no_grad()
    def exact_ldj_correction(self, input_shape):
        """The 0-d ``exact log p(x) - cheap log p(x)`` of every sample of
        shape ``input_shape`` (no batch dim): the layers' corrections,
        each at its input's shape. It depends on the parameters alone, so
        eval computes it once per epoch."""
        corr = torch.zeros((), device=self._device())
        shape = tuple(input_shape)
        for layer in self.layers:
            corr = corr + layer.exact_ldj_correction_with(
                layer.own_params(), shape)
            shape = layer.out_shape(shape)
        return corr

    def recon_loss(self, x, generator=None, sym=False, only_R=False):
        """The layers' reconstruction losses along the forward pass, (B,).
        Each layer's sees a detached input, so its gradient reaches only
        that layer's own weights; the forward between them runs without a
        graph. ``generator`` draws the dequantization noise: give it the
        state of the training forward's, as the JAX loss gives both the
        same key."""
        total = torch.zeros((x.shape[0],), device=x.device)
        for layer in self.layers:
            x = x.detach()
            if layer.has_recon_loss:
                total = total + layer.recon_loss_with(
                    layer.own_params(), x, sym=sym, only_R=only_R)
            with torch.no_grad():
                x, _ = layer(x, generator)
        return total

    def _device(self):
        """The parameters' device; the card for a flow without any."""
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cuda")

    @staticmethod
    def _generator(generator, device):
        """``generator``, or a fresh one seeded by the system."""
        if generator is None:
            generator = torch.Generator(device)
            generator.seed()
        return generator

    def _inverse(self, z, generator, noise, exact=False):
        for i in reversed(range(len(self.layers))):
            layer = self.layers[i]
            with span(layer.span_name):
                if exact and layer.has_exact_path:
                    z = layer.exact_inverse(z)
                else:
                    extra = {"noise": noise[i]} if i in noise else {}
                    z = layer.inverse(z, generator, **extra)
        return z

    @torch.inference_mode()
    def sample(self, n, generator=None, noise=None, exact=False):
        """``n`` draws: z from the base, then every layer's inverse in
        reverse order, on the parameters' device (``exact``: each layer's
        exact inverse where it has one). The draws come from
        ``generator`` (a fresh one seeded by the system when None), or
        from ``noise``: a dict of ``"base"`` -> z and
        layer index -> that ``SplitPrior``'s factored-out half."""
        with span("ift.sample"):
            device = self._device()
            generator = self._generator(generator, device)
            noise = noise or {}
            z = noise.get("base")
            if z is None:
                z, _ = self.base_distribution.sample(generator, n,
                                                     device=device)
            return self._inverse(z, generator, noise, exact)

    @torch.inference_mode()
    def reconstruct(self, x, generator=None, exact=False):
        """Forward, then inverse (``exact``: each layer's exact pair where
        it has one). ``generator`` draws the dequantization noise and
        every ``SplitPrior``'s half, which makes the round trip lossy
        there, as in the JAX package."""
        generator = self._generator(generator, x.device)
        for layer in self.layers:
            if exact and layer.has_exact_path:
                x, _ = layer.exact_forward(x)
            else:
                x, _ = layer(x, generator)
        return self._inverse(x, generator, {}, exact)

    @torch.no_grad()
    def plot_filters(self, save_dir, prefix="filters"):
        """Write every conv-kernel-shaped parameter as a heatmap-grid PNG
        (the JAX ``Flow.plot_filters``): a 4-D parameter whose last two
        dims are at most 16 is one kernel, a 5-D one (a ``RepeatedBlock``'s
        K stacked steps) K kernels, ``..._k<j>``; the file is
        ``<prefix>_<layer index>_<layer type>_<key>.png``, the key being
        the parameter's dotted name without its dots (the JAX pytree
        path). Returns the written paths."""
        import os

        from ..utils.imaging import filter_heatmap_grid, write_png

        os.makedirs(save_dir, exist_ok=True)
        written = []
        for i, layer in enumerate(self.layers):
            for name, p in layer.named_parameters():
                a = p.detach().cpu().numpy()
                key = name.replace(".", "")
                if a.ndim == 5 and a.shape[3] <= 16 and a.shape[4] <= 16:
                    kernels = [(f"{key}_k{j}", a[j])
                               for j in range(a.shape[0])]
                elif a.ndim == 4 and a.shape[2] <= 16 and a.shape[3] <= 16:
                    kernels = [(key, a)]
                else:
                    continue
                for kkey, ka in kernels:
                    out = os.path.join(
                        save_dir,
                        f"{prefix}_{i:02d}_{type(layer).__name__}_{kkey}.png")
                    write_png(out, filter_heatmap_grid(ka))
                    written.append(out)
        return written

    @property
    def has_carry(self):
        return any(layer.has_carry for layer in self.layers)

    @torch.no_grad()
    def update_carry(self):
        """Refresh every layer's carried state (ConvExp's power-iteration
        vector) against the current weights; the trainer calls it after
        each optimizer step."""
        for layer in self.layers:
            if layer.has_carry:
                layer.update_carry()

    @torch.no_grad()
    def data_init(self, x, generator=None):
        """One forward pass applying each layer's data-dependent init
        before running it."""
        for layer in self.layers:
            layer.data_init(x)
            x, _ = layer(x, generator)
