"""K identical flow steps with their parameters stacked on a leading K
axis, as in the JAX params pytree.

Port of ``inverse_flow_tpu/layers/repeated.py:RepeatedBlock`` (forward,
inverse and ``data_init``): the JAX ``lax.scan`` over the stacked parameters becomes a
loop over k that hands each step layer the k-th slices; indexing the
stacked parameters is differentiable, so their gradients stack as the
JAX ones do. ``remat`` checkpoints each step, as ``jax.checkpoint`` on the
scan body: its activations are recomputed in the backward.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
            for name in list(layer.own_params()):
                stacked = torch.stack(
                    [step[j].get_parameter(name).detach() for step in steps])
                owner, _, leaf = name.rpartition(".")
                setattr(layer.get_submodule(owner), leaf,
                        nn.Parameter(stacked))

    def _step_params(self, k):
        return [{n: t[k] for n, t in layer.own_params().items()}
                for layer in self.steps]

    def _step(self, k, x):
        ldj = zeros_ldj(x)
        for layer, pk in zip(self.steps, self._step_params(k)):
            x, l = layer.forward_with(pk, x)
            ldj = ldj + l
        return x, ldj

    def forward_with(self, p, x, generator=None):
        ldj = zeros_ldj(x)
        for k in range(self.n_repeats):
            if self.remat and torch.is_grad_enabled():
                x, l = checkpoint(self._step, k, x, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, l = self._step(k, x)
            ldj = ldj + l
        return x, ldj

    def inverse_with(self, p, z, generator=None):
        """The K steps in reverse, each step's layers in reverse, on the
        k-th slices."""
        for k in reversed(range(self.n_repeats)):
            for layer, pk in reversed(list(zip(self.steps,
                                               self._step_params(k)))):
                z = layer.inverse_with(pk, z)
        return z

    @torch.no_grad()
    def data_init_with(self, p, x):
        """Sequential data-dependent init (ActNorm) across the K steps."""
        for k in range(self.n_repeats):
            for layer, pk in zip(self.steps, self._step_params(k)):
                layer.data_init_with(pk, x)
                x, _ = layer.forward_with(pk, x)
