"""The configurations of the JAX package's ``bench.py``, built by the port.

Port of ``bench.py``'s model families (``_glow_mnist``,
``_glow_imagenet32``, ``_timescale``) and its ``CONFIGS``, under the same
names, without the timing: ``build(name, device, generator)`` gives
``(flow, data_shape, batch)``. The flagship ``glow_mnist`` (the paper's
Table-3 model), ``imagenet32`` at the reference batch of 100 and at the
JAX package's throughput batches 1024 and 4096 with bf16 coupling nets
(4096 with every step of a block checkpointed), their solver and
precision variants, and the Fig. 4 timescaling shapes.
"""

from __future__ import annotations

from ..models.glow import build_cnn_flow, build_glow

MNIST = (1, 28, 28)
IMAGENET32 = (3, 32, 32)


def _glow_mnist(**kw):
    args = dict(step_kind="inv_conv_no_pad", num_blocks=2, block_size=16,
                coupling_width=512, actnorm=True, split_prior=True,
                activation="Spline", n_bins=5, tail_bound=20.0)
    args.update(kw)
    return build_glow(MNIST, **args), MNIST, 100


def _glow_imagenet32(batch=100, **kw):
    args = dict(step_kind="inv_flow_unit", num_blocks=3, block_size=48,
                coupling_width=128, actnorm=True, split_prior=True,
                activation="SLR")
    args.update(kw)
    return build_glow(IMAGENET32, **args), IMAGENET32, batch


def _timescale(s, **kw):
    args = dict(step_kind="inv_conv_no_pad", num_blocks=1, block_size=2,
                activation="None", kernel=(2, 2))
    args.update(kw)
    return build_cnn_flow((1, s, s), **args), (1, s, s), 128


CONFIGS = {
    "glow_mnist": lambda **kw: _glow_mnist(**kw),
    "glow_mnist_fused_units": lambda **kw: _glow_mnist(
        step_kind="inv_flow_unit_fused", **kw),
    "glow_mnist_bf16_couplings": lambda **kw: _glow_mnist(
        coupling_dtype="bfloat16", **kw),
    "imagenet32": lambda **kw: _glow_imagenet32(**kw),
    "imagenet32_b1024": lambda **kw: _glow_imagenet32(
        batch=1024, coupling_dtype="bfloat16", **kw),
    "imagenet32_b4096": lambda **kw: _glow_imagenet32(
        batch=4096, remat=True, coupling_dtype="bfloat16", **kw),
    "imagenet32_exact": lambda **kw: _glow_imagenet32(
        step_kind="inv_flow_unit_exact", **kw),
    "imagenet32_bf16_couplings": lambda **kw: _glow_imagenet32(
        coupling_dtype="bfloat16", **kw),
    "timescale_s64": lambda **kw: _timescale(64, **kw),
    "timescale_s128": lambda **kw: _timescale(128, **kw),
}


def build(name, device="cuda", generator=None, **overrides):
    """``(flow, data_shape, batch)`` of ``bench.py``'s config ``name``, the
    parameters drawn from ``generator`` on ``device`` (the CUDA card
    unless the caller names another). ``overrides`` go to the build
    function over the config's own arguments (``num_blocks``,
    ``block_size``, ``coupling_width``: a smaller model of the same
    family)."""
    if name not in CONFIGS:
        raise KeyError(f"unknown bench config '{name}'; available: "
                       + ", ".join(CONFIGS))
    return CONFIGS[name](device=device, generator=generator, **overrides)
