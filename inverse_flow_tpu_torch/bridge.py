"""Weight bridge between the JAX package and the port, both ways.

The port's parameter names follow the JAX params pytree. The JAX flow's
params are a list with one pytree per layer, and the port's parameter
``layers[i].steps.1.w`` is ``params[i]["steps"][1]["w"]`` there. So the
bridge flattens each layer's pytree into dotted names and copies leaf by
leaf (:func:`params_from_jax`), and rebuilds the pytree from the dotted
names, an integer key making a list (:func:`params_to_jax`). Nested
names such as an ``InvFlowUnit`` step's ``steps.1.convs.0.w`` cross the
same way; a list takes its length from its ``ModuleList``, so an entry
without parameters keeps its place (Emerging's last flip).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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


def _unflatten(named, lengths):
    """The pytree of the dotted ``named`` leaves; a node whose keys are
    all integers is a list, of the length ``lengths`` gives for its dotted
    path (its ``ModuleList``'s), a missing entry (a layer without
    parameters: a flip, an SLR step) given as ``{}``."""
    tree = {}
    for name, value in named:
        node, keys = tree, name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node, path):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v, f"{path}{k}.") for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            n = lengths.get(path[:-1], max(map(int, node)) + 1)
            return [node.get(str(i), {}) for i in range(n)]
        return node
    return listify(tree, "")


@torch.no_grad()
def params_to_jax(flow):
    """The JAX params of ``flow``: a list with one pytree per layer, leaves
    as float32 numpy arrays (a layer without parameters gives ``{}``)."""
    return [_unflatten(((n, p.detach().cpu().numpy())
                        for n, p in layer.named_parameters()),
                       {n: len(m) for n, m in layer.named_modules()
                        if isinstance(m, (nn.ModuleList, nn.ParameterList))})
            for layer in flow.layers]
