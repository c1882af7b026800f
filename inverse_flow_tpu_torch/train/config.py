"""Typed, complete experiment configuration.

Standard-library copy of
``inverse_flow_tpu/train/config.py:ExperimentConfig``, with the same names
and defaults (``tests/test_torch_data.py`` holds it to the JAX one). Knobs
of paths the port does not run yet keep their fields, so that one config
drives both packages; :func:`check_ported` refuses the settings that would
ask for one of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ExperimentConfig:
    # identity / logging -----------------------------------------------
    name: Optional[str] = None
    notes: Optional[str] = None
    wandb: bool = False                 # the port raises when True
    wandb_project: str = "inverse_flow_tpu"
    wandb_entity: Optional[str] = None
    log_timing: bool = True
    timing_interval: int = 10           # open a timed window every Nth batch
    timing_window: int = 16             # steps per timed window
    profile_dir: Optional[str] = None
    verbose: bool = False
    log_interval: int = 100
    metrics_path: Optional[str] = None  # JSONL; default <name>_metrics.jsonl
    sample_dir: str = "samples"
    save_images: bool = True

    # schedule ----------------------------------------------------------
    epochs: int = 10_000
    eval_epochs: int = 1
    eval_train: bool = False
    eval_mc_samples: int = 1            # dequant-noise draws per eval batch
    max_eval_ex: float = float("inf")   # eval stops after this many examples
    sample_epochs: int = 10_000
    vis_epochs: int = 10_000
    n_samples: int = 100

    # optimization -------------------------------------------------------
    lr: float = 1e-3
    warmup_epochs: int = 2
    optimizer_name: str = "Adam"        # Adam | Adamax | SGD
    scheduler_name: str = "None"        # None | StepLR | MultiStepLR |
                                        # ExponentialLR | CosineAnnealingLR |
                                        # CosineAnnealingWarmRestarts
    gamma: float = 1.0                  # decay for Step/MultiStep/Exponential
    step_size: int = 25                 # StepLR epoch period
    milestones: Tuple[int, ...] = (2, 4, 50, 80, 240)
    cosine_t_max: int = 900
    cosine_t0: int = 30
    cosine_eta_min: float = 5e-8
    sgd_momentum: float = 0.95
    sgd_weight_decay: float = 1e-5
    batch_size: int = 100

    # gradient handling ----------------------------------------------------
    grad_clip_norm: Optional[float] = None
    # the reference's "grad_clip" clamps the WEIGHTS after each step
    weight_clamp: Optional[float] = None

    # flow behavior ---------------------------------------------------------
    modified_grad: bool = True
    add_recon_grad: bool = True
    sym_recon_grad: bool = False
    only_R_recon: bool = False
    recon_loss_weight: float = 1.0
    recon_loss_lr: float = 0.0
    recon_alpha: float = 0.9
    sample_true_inv: bool = False
    plot_recon: bool = True

    # checkpointing ----------------------------------------------------------
    checkpoint_path: Optional[str] = None

    # parallelism -----------------------------------------------------------
    data_parallel: bool = False
    data_parallel_impl: str = "shard_map"

    # misc --------------------------------------------------------------------
    seed: int = 0                       # seeds the dequantization noise

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self):
        return dataclasses.asdict(self)


def check_ported(cfg: ExperimentConfig):
    """Raise ``NotImplementedError`` on a setting the port cannot act on:
    data parallelism by any other impl than ``"shard_map"``'s semantics
    (the JAX ``"jit"`` impl, automatic partitioning of one global step, is
    on ROADMAP's "Do not port" list)."""
    if cfg.data_parallel and cfg.data_parallel_impl != "shard_map":
        raise NotImplementedError(
            f"data_parallel_impl={cfg.data_parallel_impl!r}: the port's data "
            f"parallelism has the 'shard_map' semantics only (one process a "
            f"rank, one gradient all-reduce); the 'jit' path is on ROADMAP's "
            f"\"Do not port\" list")
