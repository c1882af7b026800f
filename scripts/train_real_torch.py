"""Train the port's real-data Glows for several seeds and print the spread.

    python scripts/train_real_torch.py --name real_digits_glow \
        --seeds 0 1 2 --epochs 40 [--cpu]

The PyTorch port's counterpart of ``scripts/train_real_digits.py`` and
``scripts/train_real_patches.py``: ``real_digits_glow`` or
``real_patches_glow`` through ``Experiment.run()`` with those scripts'
overrides, then the test split, once per seed (weights, noise and shuffle
all from the seed). Prints one JSON line per epoch and per seed, then the
spread of the test, best-val and last-val BPD over the seeds. Metrics go to
``chiprun_out/real_data/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="real_digits_glow")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from inverse_flow_tpu_torch.experiments.real_data import (
        real_data_experiment, run_real_data)

    out = os.path.join(os.path.dirname(__file__), "..", "chiprun_out",
                       "real_data")
    os.makedirs(out, exist_ok=True)
    device = "cpu" if args.cpu else "cuda"
    finals = []
    for seed in args.seeds:
        exp = real_data_experiment(args.name, args.epochs, device, seed, out)
        exp.logger.verbose = False
        rows, final = run_real_data(exp)
        for r in rows:
            print(json.dumps(dict(r, seed=seed)), flush=True)
        finals.append(dict(final, seed=seed))
        print(json.dumps(finals[-1]), flush=True)
    spread = {k: max(f[k] for f in finals) - min(f[k] for f in finals)
              for k in ("test_bpd", "best_val_bpd", "last_val_bpd")}
    print(json.dumps({"name": args.name, "device": device,
                      "seeds": args.seeds, "spread": spread}), flush=True)


if __name__ == "__main__":
    main()
