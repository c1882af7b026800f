"""Scoring harness: log-likelihood and bits/dim over a data split.

Port of the eval subset of ``inverse_flow_tpu/train/experiment.py``
(constructor, ``to_bpd``, ``maybe_data_init``, ``eval_epoch``). Training,
sampling and checkpoints are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layers.sequential import Flow
from .config import ExperimentConfig


class Experiment:
    """Scores ``flow`` on ``device``. Dequantization noise comes from a
    ``torch.Generator`` seeded with ``config.seed``, one draw per example
    (the JAX default ``eval_mc_samples=1``)."""

    def __init__(self, flow: Flow, train_loader, val_loader, test_loader,
                 config: ExperimentConfig, device="cpu"):
        self.device = torch.device(device)
        self.flow = flow.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.cfg = config
        self.data_shape = tuple(train_loader.data_shape)
        dim = int(np.prod(self.data_shape))
        self.to_bpd = lambda logpx: -logpx / (np.log(2.0) * dim)
        self.generator = torch.Generator(self.device).manual_seed(config.seed)
        self._data_initialized = False

    def _prep_batch(self, x):
        """Host batch of raw 0-255 values -> float32 tensor on the device."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def maybe_data_init(self, x):
        """ActNorm's data-dependent init on the first batch seen."""
        if self._data_initialized:
            return
        self.flow.data_init(self._prep_batch(x), self.generator)
        self._data_initialized = True

    @torch.inference_mode()
    def eval_epoch(self, loader):
        """Mean log p(x) per example over ``loader``, up to
        ``config.max_eval_ex`` examples; the last partial batch counts."""
        sums, num = [], 0
        for x in loader:
            self.maybe_data_init(x)
            sums.append(self.flow.cheap_log_prob(self._prep_batch(x),
                                                 self.generator).sum())
            num += x.shape[0]
            if num >= self.cfg.max_eval_ex:
                break
        total = float(torch.stack(sums).sum()) if sums else 0.0
        return total / max(1, num)
