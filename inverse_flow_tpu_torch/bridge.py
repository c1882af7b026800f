"""Weight bridge from the JAX package to the port.

The port's parameter names follow the JAX params pytree. The JAX flow's
params are a list with one pytree per layer, and the port's parameter
``layers[i].steps.1.w`` is ``params[i]["steps"][1]["w"]`` there. So the
bridge flattens each layer's pytree into dotted names and copies leaf by
leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def params_from_jax(flow, jax_params):
    """Copy the JAX params (one pytree per layer, leaves as arrays that
    ``np.asarray`` takes) into ``flow``'s parameters, in place. Raises when
    a name or a shape has no counterpart."""
    if len(jax_params) != len(flow.layers):
        raise ValueError(f"{len(jax_params)} JAX layer params for "
                         f"{len(flow.layers)} layers")
    for i, (layer, tree) in enumerate(zip(flow.layers, jax_params)):
        ours = dict(layer.named_parameters())
        theirs = dict(_flatten(tree))
        if set(ours) != set(theirs):
            raise ValueError(f"layer {i} ({type(layer).__name__}): port "
                             f"params {sorted(ours)}, JAX {sorted(theirs)}")
        for name, p in ours.items():
            src = torch.tensor(np.asarray(theirs[name], np.float32))
            if src.shape != p.shape:
                raise ValueError(f"layer {i} {name}: shape {tuple(p.shape)} "
                                 f"vs JAX {tuple(src.shape)}")
            p.copy_(src)
    return flow
