"""Where a cell's time goes, by the program's own spans (PERF.md §5): one
traced run of the cell, as ``run.py --trace 1`` makes it, with every
metric read, then the trace broken down by ``ift.`` span
(:mod:`benchmark.inner`): device and idle ms a unit, the shares of each
unit's device and idle time under some span, the heaviest device ops
split by span, the spans opened a unit, and the host's time in launch
calls (a launch blocks once the device's queue is full). One JSON line
goes to standard output and to ``chiprun_out/breakdown.jsonl``.

    python3 benchmark/breakdown.py --workload glow_mnist.train_b24576 --seed 3100000037 --seconds 51
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def breakdown(t, units, launch_ns, top=12):
    """The breakdown of :class:`benchmark.trace.Trace` ``t`` over
    ``units`` profiled units; ``launch_ns``: the durations of the launch
    calls."""
    from benchmark import inner

    i = inner.Inner(t)
    by_op = collections.defaultdict(collections.Counter)
    for (a, b, _, name), label in zip(t.device, i.labels):
        by_op[name[:90]][label or "-"] += b - a
    heavy = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))
    spans = collections.Counter(s[3] for s in i.spans)

    def ms(ns_by):
        return {k: ns / 1e6 / units for k, ns in
                sorted(ns_by.items(), key=lambda kv: -kv[1])}

    return {
        "busy_ms": t.busy_ns() / 1e6 / units,
        "device_ms_by_span": ms({k or "-": v
                                 for k, v in i.device_ns().items()}),
        "idle_ms_by_span": ms(inner.idle_by_span(t, 1)),
        "shares": inner.shares(t),
        "top_ops_by_span": {name: ms(labels) for name, labels in heavy[:top]},
        "spans": {k: v / units for k, v in sorted(spans.items())},
        "launch_call_ms": sum(launch_ns) / 1e6 / units,
        "launch_calls_over_100us": sum(d > 100_000 for d in launch_ns) / units,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness, trace

    t_start = harness.process_start()
    harness.cache_dirs()
    spec = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.Cell(spec, args.workload, args.seed, args.seconds, 1)
    cell.per_layer = cell.per_layer + cell.end_to_end
    got, read = {}, trace.read

    def keep(prof):
        got["launch_ns"] = [
            e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("cudaLaunch", "cuLaunch"))]
        got["trace"] = read(prof)
        return got["trace"]

    trace.read = keep
    result = harness.run(cell, t_start)
    units = int(cell.traffic["profiled_units"])
    line = {"workload": args.workload, "seed": args.seed,
            "correct": result["correct"], "device": result["device"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "profiled_ms": 1e3 * result["device"]["window_s"] / units,
            **breakdown(got["trace"], units, got["launch_ns"])}
    print(json.dumps(line), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "breakdown.jsonl"), "a") as f:
        f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
