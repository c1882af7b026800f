"""Optimizers and learning-rate schedules on ``torch.optim``.

Port of ``inverse_flow_tpu/train/optim.py``: Adam, Adamax or SGD (with
momentum and weight decay), a per-batch linear warmup times a per-epoch
scheduler folded into one ``lr(step)``, applied by a ``LambdaLR`` stepped
once per batch, an optional global-norm gradient clip and the weight
clamp (:func:`apply_grads`). The update rules are optax's:
``tests/test_torch_train.py`` holds steps of each against optax on the
same gradients.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import clip_grad_norm_
from .config import ExperimentConfig


def _lr_factor(cfg: ExperimentConfig, steps_per_epoch: int):
    """``factor(step) = min((step+1)/warmup_steps, 1) *
    epoch_factor(step // steps_per_epoch)``."""
    warmup_steps = max(1, cfg.warmup_epochs * steps_per_epoch)

    def epoch_factor(epoch):
        name = cfg.scheduler_name
        if name in (None, "None", "none"):
            return 1.0
        if name == "StepLR":
            return cfg.gamma ** (epoch // cfg.step_size)
        if name == "MultiStepLR":
            return cfg.gamma ** sum(epoch >= m for m in cfg.milestones)
        if name == "ExponentialLR":
            return cfg.gamma ** epoch
        if name == "CosineAnnealingLR":
            t = min(epoch, cfg.cosine_t_max)
            return 0.5 * (1 + math.cos(math.pi * t / cfg.cosine_t_max))
        if name == "CosineAnnealingWarmRestarts":
            t = epoch % cfg.cosine_t0
            frac = 0.5 * (1 + math.cos(math.pi * t / cfg.cosine_t0))
            return (cfg.cosine_eta_min / cfg.lr
                    + (1 - cfg.cosine_eta_min / cfg.lr) * frac)
        raise ValueError(f"unknown scheduler: {name}")

    # fail on an unknown name here, not at the first step
    epoch_factor(0)

    def factor(step):
        warm = min((step + 1.0) / warmup_steps, 1.0)
        return warm * epoch_factor(step // steps_per_epoch)

    return factor


def make_lr_schedule(cfg: ExperimentConfig, steps_per_epoch: int):
    """``lr(step) = lr * min((step+1)/warmup_steps, 1) *
    epoch_factor(step // steps_per_epoch)``, the epoch factor from
    ``cfg.scheduler_name``."""
    factor = _lr_factor(cfg, steps_per_epoch)
    return lambda step: cfg.lr * factor(step)


def make_optimizer(cfg: ExperimentConfig, params, steps_per_epoch: int):
    """``(optimizer, scheduler)`` over ``params``. Step the scheduler once
    per batch, after the optimizer: the optimizer's k-th step (from 0)
    then runs at ``make_lr_schedule(cfg, steps_per_epoch)(k)``, as optax
    evaluates its schedule at the update count."""
    params = list(params)
    name = cfg.optimizer_name
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif name == "Adamax":
        # nu = max(b2 * nu, |g| + eps) and p -= lr * mu_hat / nu, as
        # optax.adamax (pinned by a test)
        opt = torch.optim.Adamax(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.sgd_momentum,
                              weight_decay=cfg.sgd_weight_decay)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, _lr_factor(cfg, steps_per_epoch))
    return opt, scheduler


def apply_grads(cfg: ExperimentConfig, optimizer, scheduler, params,
                model_group=None):
    """The update after a backward, as the JAX ``apply_grads``: a
    parameter without a gradient gets a zero one (optax updates every
    leaf, so Adam's moments still advance), then the optional
    global-norm clip, the optimizer and scheduler steps, and every
    parameter clamped to ``+-cfg.weight_clamp``. ``clip_grad_norm_``
    scales by ``max_norm / (norm + 1e-6)``, optax by ``max_norm / norm``.
    Under a (data, model) mesh pass its ``model_group``: the clip then
    takes the norm of the whole weights, the shards' sums of squares
    summed over the group (:func:`~inverse_flow_tpu_torch.parallel.
    clip_grad_norm_`); Adam and the clamp work element by element, on a
    shard as on the whole."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.grad_clip_norm is not None:
        if model_group is None:
            torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip_norm)
        else:
            clip_grad_norm_(params, cfg.grad_clip_norm, model_group)
    optimizer.step()
    scheduler.step()
    if cfg.weight_clamp:
        with torch.no_grad():
            for p in params:
                p.clamp_(-cfg.weight_clamp, cfg.weight_clamp)
