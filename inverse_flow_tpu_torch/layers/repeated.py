"""K identical flow steps with their parameters stacked on a leading K
axis, as in the JAX params pytree.

Port of ``inverse_flow_tpu/layers/repeated.py:RepeatedBlock`` (forward,
inverse, ``data_init``, the exact paths, the reconstruction loss, the
exact-ldj correction and the carried state): the JAX ``lax.scan`` over
the stacked parameters becomes a loop over k that hands each step layer
the k-th slices; indexing the stacked parameters is differentiable, so
their gradients stack as the JAX ones do. ``remat`` checkpoints each
step, as ``jax.checkpoint`` on the scan body: its activations are
recomputed in the backward. Every step layer keeps its input's shape (the
JAX init asserts it).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .base import FlowLayer, zeros_ldj


class RepeatedBlock(FlowLayer):
    """``make_step()`` returns one step's layers (shape preserving, no
    randomness); it is called ``n_repeats`` times so that every step gets
    its own initial parameters, which are then stacked, a step layer's
    child modules' (``InvFlowUnit``'s ``convs.i.w``, ``FincFlowUnit``'s
    ``ws.i`` in a ``ParameterList``) included: the JAX names
    ``steps.j.convs.i.w`` with shape (K, ...)."""

    def __init__(self, make_step: Callable[[], Sequence[FlowLayer]],
                 n_repeats: int, remat: bool = False):
        super().__init__()
        steps = [list(make_step()) for _ in range(n_repeats)]
        self.n_repeats = n_repeats
        self.remat = remat
        self.steps = nn.ModuleList(steps[0])
        for j, layer in enumerate(self.steps):
            for name, first in list(layer.own_params().items()):
                stacked = torch.stack(
                    [step[j].get_parameter(name).detach() for step in steps])
                owner, _, leaf = name.rpartition(".")
                setattr(layer.get_submodule(owner), leaf, nn.Parameter(
                    stacked, requires_grad=first.requires_grad))

    def _step_params(self, k):
        return [{n: t[k] for n, t in layer.own_params().items()}
                for layer in self.steps]

    def _step(self, k, x, exact=False):
        ldj = zeros_ldj(x)
        for layer, pk in zip(self.steps, self._step_params(k)):
            with span(layer.span_name):
                if exact and layer.has_exact_path:
                    x, l = layer.exact_forward_with(pk, x)
                else:
                    x, l = layer.forward_with(pk, x)
            ldj = ldj + l
        return x, ldj

    def _forward(self, x, exact):
        ldj = zeros_ldj(x)
        for k in range(self.n_repeats):
            if self.remat and torch.is_grad_enabled():
                x, l = checkpoint(self._step, k, x, exact, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, l = self._step(k, x, exact)
            ldj = ldj + l
        return x, ldj

    def forward_with(self, p, x, generator=None):
        return self._forward(x, exact=False)

    def exact_forward_with(self, p, x):
        return self._forward(x, exact=True)

    def _inverse(self, z, exact):
        for k in reversed(range(self.n_repeats)):
            for layer, pk in reversed(list(zip(self.steps,
                                               self._step_params(k)))):
                with span(layer.span_name):
                    if exact and layer.has_exact_path:
                        z = layer.exact_inverse_with(pk, z)
                    else:
                        z = layer.inverse_with(pk, z)
        return z

    def inverse_with(self, p, z, generator=None):
        """The K steps in reverse, each step's layers in reverse, on the
        k-th slices."""
        return self._inverse(z, exact=False)

    def exact_inverse_with(self, p, z):
        return self._inverse(z, exact=True)

    @property
    def has_modified_grad(self):
        """Any step layer's: ``Flow.forward(exact=True)`` must reach them."""
        return any(l.has_modified_grad for l in self.steps)

    @property
    def has_exact_path(self):
        return any(l.has_exact_path for l in self.steps)

    @property
    def has_recon_loss(self):
        return any(l.has_recon_loss for l in self.steps)

    def recon_loss_with(self, p, x, sym=False, only_R=False):
        """The step layers' reconstruction losses over the K steps, each
        on a detached input: a gradient reaches only that layer's own
        weights, within a step too (not only at step boundaries), as the
        JAX block since fec703e. The forward between them runs without
        a graph, since nothing flows back through it."""
        total = zeros_ldj(x)
        if not self.has_recon_loss:
            return total
        for k in range(self.n_repeats):
            for layer, pk in zip(self.steps, self._step_params(k)):
                x = x.detach()
                if layer.has_recon_loss:
                    total = total + layer.recon_loss_with(pk, x, sym=sym,
                                                          only_R=only_R)
                with torch.no_grad():
                    x, _ = layer.forward_with(pk, x)
        return total

    def exact_ldj_correction_with(self, p, in_shape):
        """The step layers' corrections summed over the K steps: for each
        modified-grad step layer one ``torch.func.vmap`` over its K
        stacked parameters, so the K dense slogdets run as one batched
        slogdet, as the JAX block's ``vmap``."""
        corr = super().exact_ldj_correction_with(p, in_shape)
        shape = tuple(in_shape)
        for layer in self.steps:
            if layer.has_modified_grad:
                per_step = torch.func.vmap(
                    lambda pk, lyr=layer: lyr.exact_ldj_correction_with(
                        pk, shape))(layer.own_params())
                corr = corr + per_step.sum()
        return corr

    @property
    def has_carry(self):
        return any(l.has_carry for l in self.steps)

    @torch.no_grad()
    def update_carry_with(self, p):
        """Each carrying step layer's refresh on each of the K steps'
        slices (the JAX block's ``vmap``), written into the stacked
        parameters."""
        for k in range(self.n_repeats):
            for layer, pk in zip(self.steps, self._step_params(k)):
                if layer.has_carry:
                    layer.update_carry_with(pk)

    @torch.no_grad()
    def data_init_with(self, p, x):
        """Sequential data-dependent init (ActNorm) across the K steps."""
        for k in range(self.n_repeats):
            for layer, pk in zip(self.steps, self._step_params(k)):
                layer.data_init_with(pk, x)
                x, _ = layer.forward_with(pk, x)
