"""The batch sweep that sizes the glow_mnist cells: each batch is one
traced run of the cell, at a batch other than its own, in a process of
its own, one after another; a JSON line each goes to
``chiprun_out/bench_sweep.jsonl`` and standard output.

    python3 benchmark/sweep.py --workload glow_mnist.train_b24576 --batches 8192 16384 24576 32768
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(workload, batch, seed, seconds):
    """Run in this process: the cell at ``batch``; prints its result."""
    sys.path.insert(0, ROOT)
    from benchmark import harness

    harness.cache_dirs()
    spec = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.Cell(spec, workload, seed, seconds, 1,
                        overrides={"batch": batch})
    cell.per_layer = cell.per_layer + cell.end_to_end
    harness.run(cell, harness.process_start())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--one", type=int, default=None)
    args = ap.parse_args()
    if args.one is not None:
        one(args.workload, args.one, args.seed, args.seconds)
        return
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for b in args.batches:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--batches", str(b), "--one", str(b),
             "--seed", str(args.seed), "--seconds", str(args.seconds)],
            capture_output=True, text=True, cwd=ROOT)
        sys.stderr.write(done.stderr[-3000:])
        last = done.stdout.strip().splitlines()[-1:] or ["{}"]
        line = {"workload": args.workload, "batch": b, "rc": done.returncode,
                "result": json.loads(last[0]) if last[0].startswith("{")
                else last[0]}
        print(json.dumps(line), flush=True)
        with open(os.path.join(out_dir, "bench_sweep.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
