"""Named experiments of the port.

The entries of ``inverse_flow_tpu/experiments/registry.py`` that the port
builds, under the same names and with the same ``ExperimentConfig``s (a
copy here: the port imports nothing of the JAX package): the flagship
and its FincFlow sibling, the CIFAR-10 family, the ImageNet32 Glow, the
real-data runs, and
the paper's comparison baselines (SelfNorm, Conv1x1, Emerging, ConvExp,
the CNN and FC flows), the Fig. 4 timescaling sweeps (their model is
built per size inside ``experiments/timescaling.py``, so their
``build_model`` gives None, as in JAX), and the two data-parallel
configurations, ``if_multiGPU_imagenet32`` and ``if_imagenet_multi_gpu``
(FastFlow; its spec is also ``FASTFLOW_IMAGENET32``), which train on one
card or, under ``torchrun``, one process a card
(:mod:`..parallel`). ``build_model`` takes ``device`` (the CUDA card by
default) and ``generator``. Every name of the JAX registry is here
(``NOT_PORTED`` is empty); ``memory_speed`` is the CLI's own name, in no
registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..data import cifar10, digits, imagenet, mnist, patches, synthetic
from ..models.fastflow import build_fastflow
from ..models.glow import build_cnn_flow, build_fc_flow, build_glow
from ..train.config import ExperimentConfig


@dataclass(frozen=True)
class ExperimentSpec:
    name: str
    build_model: Callable          # (device="cuda", generator=None) -> Flow
    load_data: Callable            # (batch_size, **kw) -> 3 loaders
    config: ExperimentConfig


EXPERIMENTS = {}

# the JAX registry's names still to port, by the ROADMAP item that ports
# them: none
NOT_PORTED = {}


def _register(name, build, load_data, config):
    def build_model(device="cuda", generator=None):
        return build(device=device, generator=generator)
    EXPERIMENTS[name] = ExperimentSpec(name, build_model, load_data, config)


def get_experiment(name: str) -> ExperimentSpec:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"experiment '{name}' is not ported yet (ROADMAP "
            f"{NOT_PORTED[name]})")
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment '{name}'; available: "
                       + ", ".join(sorted(EXPERIMENTS)))
    return EXPERIMENTS[name]


MNIST = (1, 28, 28)
CIFAR = (3, 32, 32)
IMAGENET32 = (3, 32, 32)
DIGITS = (1, 8, 8)
PATCHES = (3, 16, 16)

_register(
    "if_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="inv_conv_no_pad", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="Spline", n_bins=5,
                            tail_bound=20.0, **kw),
    mnist.load_data,
    ExperimentConfig(name="2L-16K_IF_Glow_MNIST", lr=1e-5, batch_size=100,
                     epochs=2000, warmup_epochs=1, gamma=0.96170,
                     scheduler_name="ExponentialLR", grad_clip_norm=None,
                     weight_clamp=0.01, modified_grad=True,
                     add_recon_grad=True, sym_recon_grad=True,
                     recon_loss_weight=0.0, sample_true_inv=True,
                     eval_train=True))

_register(
    "ff_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="ff", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="Spline", **kw),
    mnist.load_data,
    ExperimentConfig(name="2L-16K FF Glow MNIST", lr=1e-5, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     sym_recon_grad=True, recon_loss_weight=10.0,
                     weight_clamp=0.01, scheduler_name="None"))

# ---------------------------------------------------------------------------
# CIFAR-10 family (JAX registry.py:208-252)
# ---------------------------------------------------------------------------
_register(
    "if_glow_cifar",
    lambda **kw: build_glow(CIFAR, step_kind="inv_conv_no_pad", num_blocks=2,
                            block_size=16, coupling_width=128,
                            actnorm=False, split_prior=True,
                            activation="Spline", **kw),
    cifar10.load_data,
    ExperimentConfig(name="IF Glow CIFAR", lr=1e-4, batch_size=140,
                     gamma=0.1097170, modified_grad=False,
                     add_recon_grad=False, weight_clamp=0.01,
                     warmup_epochs=2, scheduler_name="None"))

_register(
    "selfnorm_glow_cifar",
    lambda **kw: build_glow(CIFAR, step_kind="snf", num_blocks=2,
                            block_size=4, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    cifar10.load_data,
    ExperimentConfig(name="SNF Glow CIFAR", lr=1e-3, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     sym_recon_grad=True, recon_loss_weight=1000.0,
                     weight_clamp=0.001, scheduler_name="None"))

_register(
    "conv1x1_glow_cifar",
    lambda **kw: build_glow(CIFAR, step_kind="conv1x1", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    cifar10.load_data,
    ExperimentConfig(name="Conv1x1 Glow CIFAR", lr=1e-3, batch_size=100,
                     modified_grad=False, add_recon_grad=False,
                     scheduler_name="None"))

_register(
    "ff_glow_cifar",
    lambda **kw: build_glow(CIFAR, step_kind="ff", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="Spline", **kw),
    cifar10.load_data,
    ExperimentConfig(name="FF Glow CIFAR", lr=1e-5, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     recon_loss_weight=10.0, scheduler_name="None"))

_register(
    "if_glow_imagenet32",
    lambda **kw: build_glow(IMAGENET32, step_kind="inv_conv_no_pad",
                            num_blocks=3, block_size=48, coupling_width=256,
                            actnorm=True, split_prior=True,
                            activation="Spline", **kw),
    lambda **kw: imagenet.load_data(size=32, **kw),
    ExperimentConfig(name="IF Glow ImageNet32", lr=1e-5, batch_size=100,
                     modified_grad=True, add_recon_grad=False,
                     scheduler_name="None"))

_register(
    "real_digits_glow",
    lambda **kw: build_glow(DIGITS, step_kind="inv_flow_unit", num_blocks=2,
                            block_size=4, coupling_width=64, actnorm=True,
                            split_prior=True, activation="SLR", **kw),
    digits.load_data,
    ExperimentConfig(name="IF Glow RealDigits", lr=1e-3, batch_size=100,
                     epochs=30, warmup_epochs=2, modified_grad=True,
                     add_recon_grad=False, recon_loss_weight=0.0,
                     scheduler_name="None", eval_train=False))

_register(
    "real_patches_glow",
    lambda **kw: build_glow(PATCHES, step_kind="inv_flow_unit",
                            num_blocks=2, block_size=4, coupling_width=64,
                            actnorm=True, split_prior=True, activation="SLR",
                            **kw),
    patches.load_data,
    ExperimentConfig(name="IF Glow RealPatches", lr=1e-3, batch_size=104,
                     epochs=30, warmup_epochs=2, modified_grad=True,
                     add_recon_grad=False, recon_loss_weight=0.0,
                     scheduler_name="None", eval_train=False))

# ---------------------------------------------------------------------------
# FC MNIST (JAX registry.py:52-73)
# ---------------------------------------------------------------------------
_register(
    "exact_fc_mnist",
    lambda **kw: build_fc_flow(MNIST, num_layers=2, kind="inv_conv_no_pad",
                               activation="Spline", tail_bound=10.0, **kw),
    mnist.load_data,
    ExperimentConfig(name="2L IF FC Exact MNIST", lr=1e-4, batch_size=100,
                     modified_grad=False, add_recon_grad=False,
                     warmup_epochs=2, recon_loss_weight=0.0,
                     sample_true_inv=False, scheduler_name="None"))

_register(
    "selfnorm_fc_mnist",
    lambda **kw: build_fc_flow(MNIST, num_layers=2, kind="snf_fc",
                               activation="Spline", tail_bound=10.0, **kw),
    mnist.load_data,
    ExperimentConfig(name="2L SNF FC MNIST", lr=1e-4, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     recon_loss_weight=1.0, scheduler_name="None"))

# ---------------------------------------------------------------------------
# CNN MNIST (JAX registry.py:74-136)
# ---------------------------------------------------------------------------
_register(
    "if_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="inv_conv_no_pad",
                                num_blocks=3, block_size=16,
                                activation="Spline", n_bins=10,
                                tail_bound=30.0, kernel=(2, 2), **kw),
    mnist.load_data,
    ExperimentConfig(name="cnn_IF_Spline MNIST", lr=1e-5, batch_size=100,
                     epochs=100, modified_grad=True, add_recon_grad=False,
                     recon_loss_weight=0.0, weight_clamp=0.01,
                     warmup_epochs=2, scheduler_name="None"))

_register(
    "if_exact_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="inv_conv_no_pad",
                                num_blocks=3, block_size=3,
                                activation="Spline", n_bins=10,
                                tail_bound=30.0, kernel=(2, 2), **kw),
    mnist.load_data,
    ExperimentConfig(name="IF exact cnn MNIST", lr=1e-5, batch_size=100,
                     epochs=100, modified_grad=False, add_recon_grad=False,
                     weight_clamp=0.01, grad_clip_norm=1.0,
                     scheduler_name="None"))

_register(
    "exact_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="inv_conv_no_pad",
                                num_blocks=3, block_size=3,
                                activation="Spline", kernel=(3, 3), **kw),
    mnist.load_data,
    ExperimentConfig(name="9L Exact CNN MNIST", lr=1e-4, batch_size=1000,
                     modified_grad=False, add_recon_grad=False,
                     scheduler_name="None"))

_register(
    "selfnorm_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="snf_cnn", num_blocks=3,
                                block_size=3, activation="Spline", **kw),
    mnist.load_data,
    ExperimentConfig(name="9L SNF CNN MNIST", lr=1e-3, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     recon_loss_weight=1.0, scheduler_name="None"))

_register(
    "emerging_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="emerging", num_blocks=2,
                                block_size=4, activation="Spline",
                                n_bins=10, tail_bound=70.0, **kw),
    mnist.load_data,
    ExperimentConfig(name="9L Emerging Spline MNIST", lr=1e-3,
                     batch_size=100, modified_grad=False,
                     add_recon_grad=False, scheduler_name="None"))

_register(
    "exponential_cnn_mnist",
    lambda **kw: build_cnn_flow(MNIST, step_kind="convexp", num_blocks=3,
                                block_size=3, activation="Spline",
                                tail_bound=10.0, **kw),
    mnist.load_data,
    ExperimentConfig(name="9L Conv Exponential Spline MNIST", lr=1e-3,
                     batch_size=100, modified_grad=False,
                     add_recon_grad=False, scheduler_name="None"))

# ---------------------------------------------------------------------------
# Glow MNIST baselines (JAX registry.py:155-196)
# ---------------------------------------------------------------------------
_register(
    "selfnorm_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="snf", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    mnist.load_data,
    ExperimentConfig(name="2L-16K SNF Glow MNIST", lr=1e-3, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     recon_loss_weight=100.0, weight_clamp=0.01,
                     scheduler_name="None"))

_register(
    "geco_selfnorm_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="snf", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    mnist.load_data,
    ExperimentConfig(name="GECO SNF Glow MNIST", lr=1e-3, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     recon_loss_weight=1.0, recon_loss_lr=1e-3,
                     scheduler_name="None"))

_register(
    "conv1x1_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="conv1x1", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    mnist.load_data,
    ExperimentConfig(name="2L-16K Conv1x1 Glow MNIST", lr=1e-3,
                     batch_size=100, modified_grad=False,
                     add_recon_grad=False, weight_clamp=0.01,
                     scheduler_name="None"))

_register(
    "if_conv1x1_glow_mnist",
    lambda **kw: build_glow(MNIST, step_kind="inv_conv", num_blocks=2,
                            block_size=16, coupling_width=512, actnorm=True,
                            split_prior=True, activation="Spline", **kw),
    mnist.load_data,
    ExperimentConfig(name="IF+Conv1x1 Glow MNIST", lr=1e-5, batch_size=100,
                     modified_grad=True, add_recon_grad=False,
                     scheduler_name="None"))

# ---------------------------------------------------------------------------
# ImageNet32 baselines (JAX registry.py:268-287)
# ---------------------------------------------------------------------------
_register(
    "selfnorm_glow_imagenet",
    lambda **kw: build_glow(IMAGENET32, step_kind="snf", num_blocks=3,
                            block_size=48, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    lambda **kw: imagenet.load_data(size=32, **kw),
    ExperimentConfig(name="SNF Glow ImageNet32", lr=1e-3, batch_size=100,
                     modified_grad=True, add_recon_grad=True,
                     scheduler_name="None"))

_register(
    "conv1x1_glow_imagenet",
    lambda **kw: build_glow(IMAGENET32, step_kind="conv1x1", num_blocks=3,
                            block_size=48, coupling_width=512, actnorm=True,
                            split_prior=True, activation="None", **kw),
    lambda **kw: imagenet.load_data(size=32, **kw),
    ExperimentConfig(name="Conv1x1 Glow ImageNet32", lr=1e-3,
                     batch_size=100, modified_grad=False,
                     add_recon_grad=False, scheduler_name="None"))

# ---------------------------------------------------------------------------
# Data parallel (JAX registry.py:287-317): ImageNet32 Glow at width 256,
# B=250, and FastFlow, B=100
# ---------------------------------------------------------------------------
_register(
    "if_multiGPU_imagenet32",
    lambda **kw: build_glow(IMAGENET32, step_kind="inv_conv_no_pad",
                            num_blocks=3, block_size=48, coupling_width=256,
                            actnorm=True, split_prior=True,
                            activation="Spline", **kw),
    lambda **kw: imagenet.load_data(size=32, **kw),
    ExperimentConfig(name="IF Glow ImageNet32 DP", lr=1e-5, batch_size=250,
                     modified_grad=True, add_recon_grad=False,
                     data_parallel=True, scheduler_name="None"))

_register(
    "if_imagenet_multi_gpu",
    lambda **kw: build_fastflow(IMAGENET32, n_blocks=3, block_size=48,
                                actnorm=False, coupling_width=512, **kw),
    lambda **kw: imagenet.load_data(size=32, **kw),
    ExperimentConfig(name="FastFlow ImageNet32 DP", lr=1e-5, batch_size=100,
                     modified_grad=True, add_recon_grad=False,
                     data_parallel=True, scheduler_name="None"))
FASTFLOW_IMAGENET32 = EXPERIMENTS["if_imagenet_multi_gpu"]

# ---------------------------------------------------------------------------
# FC on the embedded real digits (JAX registry.py:381-389)
# ---------------------------------------------------------------------------
_register(
    "real_digits_fc",
    lambda **kw: build_fc_flow(DIGITS, num_layers=2, kind="inv_conv_no_pad",
                               activation="Spline", tail_bound=10.0, **kw),
    digits.load_data,
    ExperimentConfig(name="2L IF FC RealDigits", lr=1e-4, batch_size=100,
                     modified_grad=False, add_recon_grad=False,
                     warmup_epochs=2, recon_loss_weight=0.0,
                     scheduler_name="None"))

# ---------------------------------------------------------------------------
# Timescaling (JAX registry.py:319-378): train-step time against input size
# on synthetic data; the model is built per size by run_timescaling
# ---------------------------------------------------------------------------
for _tname, _tlabel, _tlr in (
        ("if_timescaling", "IF timescaling", 1e-5),
        ("if_jacobi_timescaling", "IF jacobi timescaling", 1e-5),
        ("if_auto_timescaling", "IF auto timescaling", 1e-5),
        ("snf_timescaling", "SNF timescaling", 1e-3),
        ("if_tall_timescaling", "IF tall timescaling", 1e-5),
        ("if_jacobi_tall_timescaling", "IF jacobi tall timescaling", 1e-5),
        ("if_auto_tall_timescaling", "IF auto tall timescaling", 1e-5)):
    _register(
        _tname, lambda **kw: None, synthetic.load_data,
        ExperimentConfig(name=_tlabel, lr=_tlr, batch_size=128,
                         modified_grad=True, add_recon_grad=False,
                         scheduler_name="None"))

TIMESCALING = tuple(n for n in EXPERIMENTS if n.endswith("timescaling"))
