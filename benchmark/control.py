"""The readings that set the limits of ``correct``: for each seed, in one
process on the card at the cell's own size, the program's numbers against
the plain reference (sound runs: the lower reading), the reference in the
precision below the configuration's, TF32 for float32 (the control: the
upper reading), and, for a train cell, the reference with each step on
half of its batch (a fault). The benchmark's own runs do not run this.

    python3 benchmark/control.py --workload glow_mnist.train_b24576 --seeds 1 2 3

One JSON line a seed: {"seed", "program": {number: value}, "control":
{...}, "half_batch": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(numbers):
    return {k: v["value"] for k, v in numbers.items()}


def readings(cell, entry):
    """{"program": ..., "control": ..., ["half_batch": ...]} of ``cell``."""
    import torch

    state = entry.setup(cell)
    out = {}
    if cell.traffic["entry"] == "train":
        state.pop("exp")
        gc.collect()
        if cell.device != "cpu":
            torch.cuda.empty_cache()
        pool, seed = state["pool"], state["noise_seed"]
        prog = (state["losses"], state["grad_norms"], state["change"])
        exact = entry.reference_readings(cell, pool, seed)
        out["losses"] = {"program": prog[0], "reference": exact[0]}
        out["program"] = _values(entry.compared(cell, prog, exact))
        for name, kw in (("control", {"control": True}),
                         ("half_batch", {"keep": cell.traffic["batch"] // 2})):
            other = entry.reference_readings(cell, pool, seed, **kw)
            out[name] = _values(entry.compared(cell, other[:3], exact))
    else:
        for k in range(len(state["pool"])):
            entry.unit(state, k)
        state.pop("flow")
        gc.collect()
        if cell.device != "cpu":
            torch.cuda.empty_cache()
        args = (cell, state["images"], state["noise_seed"], state["pool"])
        exact = entry.reference_images(*args)
        out["program"] = _values(entry.compared(cell, state["kept"], exact))
        control = entry.reference_images(*args, control=True)
        out["control"] = _values(entry.compared(cell, control, exact))
    return out


def main(argv=None, device="cuda", overrides=None):
    sys.path.insert(0, ROOT)
    from benchmark import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    spec = harness.load_json(ROOT, "BENCHMARK.json")
    import torch

    lines = []
    for seed in args.seeds:
        cell = harness.Cell(spec, args.workload, seed, 0, 0, device=device,
                            overrides=overrides)
        entry = harness.load_module("entries", cell.traffic["entry"])
        tf32 = bool(cell.config["precision"]["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        line = {"workload": args.workload, "seed": seed,
                **readings(cell, entry)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
