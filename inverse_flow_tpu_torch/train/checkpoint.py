"""Checkpoint save and load of the whole train state.

Port of ``inverse_flow_tpu/train/checkpoint.py`` with ``torch.save``: one
file holds the flow's state dict, the optimizer's and the scheduler's, the
step, GECO's ``recon_weight`` and ``recon_ema``, the summary and the
config. It is written to ``path + ".tmp"`` and
then renamed, so a crash never leaves half a checkpoint. No Orbax backend.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path, flow, optimizer, scheduler, step, summary,
                    config_dict, recon_weight, recon_ema):
    payload = {
        "flow": flow.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "step": int(step),
        "recon_weight": torch.as_tensor(recon_weight).detach().cpu(),
        "recon_ema": torch.as_tensor(recon_ema).detach().cpu(),
        # plain floats: numpy scalars do not load with weights_only
        "summary": {k: (v if isinstance(v, (int, str)) else float(v))
                    for k, v in summary.items()},
        "config": dict(config_dict),
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, config_dict=None, log=print, map_location=None):
    """The saved payload (tensors on ``map_location``); logs a warning with
    the sorted config keys whose values differ from ``config_dict``."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if config_dict is not None:
        old = payload["config"]
        diff = {k for k in set(old) | set(config_dict)
                if old.get(k) != config_dict.get(k)}
        if diff:
            log(f"Warning: differences in loaded config: {sorted(diff)}")
    return payload
