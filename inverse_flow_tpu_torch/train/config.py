"""Experiment configuration.

The scoring subset of ``inverse_flow_tpu/train/config.py:ExperimentConfig``,
with the same names and defaults. The training knobs come with the
training port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ExperimentConfig:
    name: Optional[str] = None
    batch_size: int = 100
    max_eval_ex: float = float("inf")   # eval stops after this many examples
    seed: int = 0                       # seeds the dequantization noise
