"""Training runs on the embedded real data, as the JAX scripts make them.

``real_digits_glow`` and ``real_patches_glow`` with the overrides of
``scripts/train_real_digits.py`` (eval every epoch, no sampling past the
schedule's first epochs, no timing, images or reconstruction plots),
driven through :meth:`Experiment.run`, then the test split scored after
the last epoch as that script does.
"""

from __future__ import annotations

import json
import os

import torch

from ..train.experiment import Experiment
from .registry import get_experiment


def real_data_experiment(name, epochs=40, device="cuda", seed=0,
                         out_dir=".", tag=""):
    """The registry's ``name`` with the real-data script's overrides; the
    weights, the dequantization noise and the loader's shuffle all drawn
    from ``seed``. Metrics and the checkpoint go to ``out_dir``, named
    after ``name``, ``seed`` and ``tag``."""
    spec = get_experiment(name)
    stem = os.path.join(out_dir, f"{name}_{seed}{tag}")
    cfg = spec.config.replace(
        epochs=epochs, eval_epochs=1, sample_epochs=10_000, log_timing=False,
        save_images=False, plot_recon=False, seed=seed,
        metrics_path=f"{stem}_metrics.jsonl",
        checkpoint_path=f"{stem}_checkpoint.pt")
    if os.path.exists(cfg.metrics_path):
        os.remove(cfg.metrics_path)
    flow = spec.build_model(
        device=device, generator=torch.Generator(device).manual_seed(seed))
    loaders = spec.load_data(batch_size=cfg.batch_size, seed=seed)
    return Experiment(flow, *loaders, cfg, device=device)


def run_real_data(exp):
    """``exp.run()``, then the test split. Returns (rows, final): per epoch
    the mean train loss and the val BPD, and the test BPD after the last
    epoch beside the first, best and last val BPD."""
    exp.run()
    test_bpd = float(exp.to_bpd(exp.eval_epoch(exp.test_loader)))
    exp.logger.close()
    with open(exp.cfg.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["value"] for r in recs if r["name"] == "Train Avg Loss"]
    bpds = [r["value"] for r in recs if r["name"] == "Val BPD"]
    rows = [{"epoch": e + 1, "train_loss": loss, "val_bpd": bpd}
            for e, (loss, bpd) in enumerate(zip(losses, bpds))]
    final = {"epochs": len(rows), "test_bpd": test_bpd,
             "first_val_bpd": bpds[0], "best_val_bpd": min(bpds),
             "last_val_bpd": bpds[-1]}
    return rows, final
