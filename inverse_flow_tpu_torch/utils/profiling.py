"""Profiler traces, the program's spans and the card's timers.

Port of ``inverse_flow_tpu/utils/profiling.py:trace`` on ``torch.profiler``:
host and CUDA activity of the block, written as a Chrome trace into
``profile_dir``. :func:`span` marks the program's layer boundaries in
whatever profiler records (``ift.*``, listed in :data:`SPANS`). Beside
them, the timers that ``bench.py`` and ``chip_smoke.py`` share:
:func:`time_ms` and :func:`ab_ms` (CUDA events) and :func:`device_profile`
(device busy time, idle share and launch calls from the profiler's raw
events).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# every span the program opens, and where
SPANS = {
    "ift.step": "Experiment.train_step, whole",
    "ift.step.forward": "train_step: Flow.forward, the NaN scrub, the loss "
                        "(and the recon loss)",
    "ift.step.backward": "train_step: the backward",
    "ift.step.optim": "train_step: apply_grads, update_carry, GECO",
    "ift.sample": "Flow.sample, whole",
    "ift.actnorm": "an ActNorm's call in the layer loops of Flow and "
                   "RepeatedBlock",
    "ift.solve": "an InvFlow's or InvFlowUnit's call in those loops",
    "ift.act": "an activation's call in those loops",
    "ift.coupling": "a Coupling's call in those loops",
    "ift.prior": "a SplitPrior's call in those loops",
    "ift.solve.build": "fused_chain.chain_inputs: the operator build, "
                       "forward and backward",
    "ift.solve.chain": "fused_chain.chain_phases: the chain launch, forward "
                       "and backward",
    "ift.coupling.net": "Coupling._net (again in the backward when the net "
                        "is recomputed)",
}

_NULL = contextlib.nullcontext()


def span(name):
    """The span ``name`` (one of :data:`SPANS`, or None for none) while a
    profiler records, else one shared null context. A span is a record
    function of FUNCTION scope (``_RecordFunctionFast``): it lands in the
    profiler's host events on the kernels' clock, and kineto does not copy
    it onto the device timeline as it does ``record_function``'s
    USER_SCOPE ranges. With no profiler a span costs the state test."""
    if name is None or not _profiler_enabled():
        return _NULL
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Trace the block into ``profile_dir/trace.json`` (a no-op for
    None), the program's spans (:data:`SPANS`) included. CUDA activity
    is recorded when a card is present."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def time_ms(fn, reps, ahead=False):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events.
    ``ahead``: the device first sleeps for about ``reps`` x 50 us (times
    ``ahead`` where it is a number), so that the host queues the calls
    before the device reaches them and the events time the device's work,
    not the host's launch rate (a chain launch of 10-20 us takes about as
    long to enqueue)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        # cycles, about 1.9 GHz
        torch.cuda._sleep(int(ahead) * reps * 100_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(fns, reps, rounds, ahead=False):
    """Median ms per call of each of ``fns`` (dict), timed in turns
    (a, b, b, a, ...) after one warm-up call each (``ahead``: see
    :func:`time_ms`)."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            times[k].append(time_ms(fns[k], reps, ahead))
    return {k: statistics.median(v) for k, v in times.items()}


def device_profile(name, unit, fn, n, card, out_dir):
    """``n`` calls of ``fn`` under ``torch.profiler``: host ms per call,
    device busy ms (the union of device intervals), idle share, device
    ops, kernel launch calls, and device ms by op, per ``unit``; the
    table of device ms by op goes to ``<out_dir>/profile_<name>.txt``.
    Returns (busy ms, launch calls, idle share) per call.

    It reads the profiler's raw events (``kineto_results.events()``), not
    ``prof.events()``/``key_averages()``: those build an event tree that
    took 50 s of host time for one imagenet32 step on the H100's host
    (this 3.6 s). A device op's time goes to the op that launched it
    (``linked_correlation_id``), as ``key_averages``' self device time
    does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / n
    print(f"profile: {name} {prof_ms:.3f} ms/{unit} under the profiler "
          f"({n} calls) {card}", flush=True)

    def api_call(op):                   # cudaLaunchKernel, cuLaunchKernel
        return op[:4] == "cuda" or op[:2] == "cu" and op[2:3].isupper()

    events = prof.profiler.kineto_results.events()
    op_names, calls, launches, spans = {}, {}, 0, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            spans.append((e.start_ns(), e.end_ns(),
                          e.linked_correlation_id()))
        elif e.name().startswith("cudaLaunch"):
            launches += 1
        elif not api_call(e.name()):
            op_names[e.correlation_id()] = e.name()
            calls[e.name()] = calls.get(e.name(), 0) + 1
    spans.sort()
    busy, end, by_op = 0, float("-inf"), {}
    for a, b, op in spans:              # union of device intervals, ns
        busy += max(0, b - max(a, end))
        end = max(end, b)
        key = op_names.get(op, "(no op)")
        by_op[key] = by_op.get(key, 0) + b - a
    busy_ms = busy / 1e6 / n
    idle = 1 - busy_ms / prof_ms
    print(f"profile: {name} device busy {busy_ms:.3f} ms/{unit} of "
          f"{prof_ms:.3f} (idle share {idle:.3f}); "
          f"{len(spans) / n:.0f} device ops and {launches / n:.0f} kernel "
          f"launch calls per {unit} {card}", flush=True)
    rows = [f"{k} {v / n / 1e6:.3f} ({calls.get(k, 0) // n})"
            for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])]
    print(f"profile: {name} device ms/{unit} by op: " + ", ".join(rows[:8]),
          flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(f"{card} {name}, {n} calls; device ms/{unit} by op "
                f"(calls/{unit})\n" + "\n".join(rows[:60]) + "\n")
    return busy_ms, launches / n, idle
