"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, which names the entry that the window drives
(``entries/<entry>.py``) and the runner that starts the cell's processes
(``runners/<runner>.py``), the limits of the correctness check
``limits/<cell>.json``, and a reader ``metrics/<metric>.py`` for every
metric. A later PR adds a cell, a mix or a metric as new files.

The run: set-up (the entry builds the program and its state from the
seed and warms up every shape the window uses), the measured window of
``--seconds`` (closed loop: one unit after another, each read back), the
peak memory read, with ``--trace 1`` a few more units under the profiler,
then the correctness check against the plain reference once the program's
state is freed. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# what the run may not have loaded: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "inverse_flow_tpu")


def process_start():
    """The process's start on the ``time.time()`` clock (from /proc), or
    None where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} '{name}' ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``inverse_flow_tpu_torch`` is not
    ``inverse_flow_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, spec, name, seed, seconds, trace, device="cuda",
                 overrides=None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload '{name}' in BENCHMARK.json; "
                           f"cells: {', '.join(cells)}")
        self.spec = spec
        self.workload = cells[name]
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.config = load_json(HERE, "configs",
                                f"{self.workload['config']}.json")
        self.traffic = load_json(HERE, "traffic",
                                 f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE, "limits", f"{name}.json")
        for key, value in (overrides or {}).items():
            # CPU rehearsals only: a smaller model or batch
            target = self.config["model"] if key in self.config["model"] \
                else self.traffic
            target[key] = value
        self.end_to_end = self._metrics(spec["end_to_end"])
        self.per_layer = self._metrics(spec["per_layer"])

    def _metrics(self, entries):
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]


class Context:
    """What the metric readers read: the window's counts and times, the
    trace, the model's math, the card's peaks."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.units = 0               # units completed in the window
        self.images = 0              # images they carried
        self.window_s = None         # window start to the last unit's end
        self.peak_setup_bytes = 0
        self.peak_window_bytes = None
        self.trace = None            # benchmark.trace.Trace of the profiled units
        self.traced_units = 0
        self.traced_s = None
        self.work = None             # benchmark.work.model_work of one unit
        self.peaks = None            # benchmark.work.peaks of the card

    @property
    def entry(self):
        return self.cell.traffic["entry"]

    @property
    def unit_s(self):
        """Untraced wall seconds a unit (step or draw)."""
        return self.window_s / self.units if self.units else None


def read_metrics(ctx, entries):
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, state, entry, ctx, t_start):
    """The window, the peak memory, and with ``cell.trace`` the profiled
    units and the per-layer readings."""
    import torch

    from . import trace as trace_mod
    from . import work

    dev = torch.device(cell.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        ctx.peak_setup_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.time() - t_start
    t0 = time.perf_counter()
    k = 0
    while True:
        ctx.images += entry.unit(state, k)
        k += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= cell.seconds:
            break
    ctx.units, ctx.window_s = k, elapsed
    if on_card:
        ctx.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
    ctx.work = work.model_work(cell.config, cell.traffic["batch"],
                               cell.traffic["direction"])
    if not cell.trace:
        return k
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import spans

    saved = spans.install()
    try:
        with record_function("bench.unit"):
            entry.unit(state, k)         # the spans' first call, untraced
        k += 1
        n = int(cell.traffic["profiled_units"])
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for j in range(n):
                with record_function("bench.unit"):
                    entry.unit(state, k + j)
            if on_card:
                torch.cuda.synchronize()
            ctx.traced_s = time.perf_counter() - t1
        k += n
        ctx.traced_units = n
    finally:
        spans.uninstall(saved)
    ctx.trace = trace_mod.read(prof)
    if on_card:
        ctx.peaks = work.peaks(torch.cuda.get_device_name(dev))
    return k


def run(cell, t_start, out=sys.stdout, err=sys.stderr):
    """Set up, measure and check ``cell``; returns the result dict (also
    printed as the last line of ``out``), or raises."""
    import torch

    entry = load_module("entries", cell.traffic["entry"])
    runner = load_module("runners", cell.traffic["runner"])
    ctx = Context(cell)
    t_entry = time.time()
    state = runner.setup(cell, entry)
    measure(cell, state, entry, ctx, t_start)
    print(f"benchmark: set-up {ctx.setup_s:.1f} s: {t_entry - t_start:.1f} s "
          f"to the entry (interpreter, imports), "
          f"{ctx.setup_s - (t_entry - t_start):.1f} s in it (CUDA context, "
          f"kernels, build, weights, data init, warm-up)", file=err)
    dev = torch.device(cell.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": int(cell.workload["chips"]),
              "memory_peak_bytes": (max(ctx.peak_setup_bytes,
                                        torch.cuda.max_memory_allocated(dev))
                                    if dev.type == "cuda" else 0)}
    metrics = read_metrics(ctx, cell.per_layer if cell.trace
                           else cell.end_to_end)
    failed = entry.failed(state)
    result = {"attempted": ctx.units, "failed": failed, "metrics": metrics,
              "device": device}
    if cell.trace:
        t = ctx.trace
        device["busy_s"] = t.busy_ns() / 1e9
        device["window_s"] = ctx.traced_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
        ctx.trace = None
    t_check = time.perf_counter()
    checks = runner.check(cell, entry, state)
    print(f"benchmark: the check took {time.perf_counter() - t_check:.1f} s",
          file=err)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {', '.join(bad)}, which the "
                           f"port's benchmark may not load")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    out_line = {"correct": bool(correct), **result, "checks": checks}
    print(json.dumps(out_line), file=out, flush=True)
    return out_line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own kernels build into ``build/kernels``."""
    base = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None):
    t_start = process_start() or time.time()
    args = parse(argv)
    cache_dirs()
    spec = load_json(ROOT, "BENCHMARK.json")
    import torch

    cell = Cell(spec, args.workload, args.seed, args.seconds, args.trace)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    try:
        run(cell, t_start)
    except Exception as e:                  # noqa: BLE001 - reported, rc 1
        import traceback

        traceback.print_exc()
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0
