"""The traced run's spans, opened from the benchmark around calls into
the program's layers.

The program's ``Flow`` and ``RepeatedBlock`` call each layer's
``forward_with`` / ``inverse_with`` directly, so module hooks do not
fire: the methods themselves are wrapped, on their classes, while the
traced run sets up, and put back afterwards. Each wrapped call runs inside
``torch.profiler.record_function("bench.<kind>")``. Kinds:

* ``actnorm``: ``ActNorm``;
* ``solve``: the masked-conv inverse (``InvFlow``, ``InvFlowNoPad``,
  ``InvFlowUnit``): the operator build, the chain launch and its
  bookkeeping in the forward; the sampling direction's masked conv in
  ``inverse_with``;
* ``act``: the elementwise activation (``SplineActivation``,
  ``SmoothLeakyRelu``);
* ``coupling``: ``Coupling`` (and the coupling inside ``SplitPrior``).

Their backward ops are found by the trace reader through the autograd
sequence numbers (:mod:`benchmark.trace`).
"""

from __future__ import annotations

import functools

# (module, class, kind) of the program's layers that get spans
LAYERS = (
    ("inverse_flow_tpu_torch.layers.actnorm", "ActNorm", "actnorm"),
    ("inverse_flow_tpu_torch.layers.inv_flow", "InvFlow", "solve"),
    ("inverse_flow_tpu_torch.layers.inv_flow", "InvFlowUnit", "solve"),
    ("inverse_flow_tpu_torch.layers.activations", "SplineActivation", "act"),
    ("inverse_flow_tpu_torch.layers.activations", "SmoothLeakyRelu", "act"),
    ("inverse_flow_tpu_torch.layers.coupling", "Coupling", "coupling"),
)
METHODS = ("forward_with", "inverse_with")


def _wrap(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def install():
    """Wrap the layers' methods; returns the list to :func:`uninstall`."""
    import importlib

    saved = []
    for module, cls_name, kind in LAYERS:
        cls = getattr(importlib.import_module(module), cls_name)
        for m in METHODS:
            if m in vars(cls):
                saved.append((cls, m, vars(cls)[m]))
                setattr(cls, m, _wrap(vars(cls)[m], f"bench.{kind}"))
    return saved


def uninstall(saved):
    for cls, m, fn in reversed(saved):
        setattr(cls, m, fn)
