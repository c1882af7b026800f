#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's scoring path (``Experiment.maybe_data_init`` ->
``Flow.cheap_log_prob`` -> ``to_bpd``) once on the flagship model
``if_glow_mnist`` at full width (L=2 blocks x K=16 steps, coupling width
512, RQ spline 5 bins, batch 100; random weights from seed 0), in phases:

  1. device: the card's name and power limit;
  2. build: the chain kernel from ``inverse_flow_tpu_torch/csrc``;
  3. kernel: the kernel against its plain PyTorch version on the card at
     the main path's shapes (and both scan directions, the padded tail and
     a four-order chain), with its time beside the plain version's;
  4. slice: data init and eval over 5 validation batches, BPD, the kernel's
     launch count, log p(x) against the same model on the plain chain, and
     eval ms/batch;
  5. profile: where the time of one eval batch goes
     (:func:`profile_eval`).

Every phase prints one line or more; the line before the last is the
kernel summary as JSON, the last ``{"ok": true, "device": ...}``. Any
failed check exits non-zero with no result line. Without a CUDA card it
fails at once: nothing runs on the CPU. Float32 throughout, TF32 off for
matmuls and cuDNN.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 100
EVAL_EXAMPLES = 500
# the main path's solve shapes (C, H, W), and the kernel cases: both scan
# directions, the padded tail of (8, 7, 7), and a four-order chain
FLAGSHIP_SHAPES = [(4, 14, 14), (8, 7, 7)]
KERNEL_CASES = [((4, 14, 14), ("TL",)), ((8, 7, 7), ("TL",)),
                ((8, 7, 7), ("BR",)), ((4, 14, 14), ("TL", "TR", "BL", "BR"))]
# |log p(x)| differences from summation order alone, float32, 38 layers
LOGPX_RTOL = 1e-4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps, torch):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(fns, reps, rounds, torch):
    """Median ms per call of each of ``fns`` (dict), timed in turns
    (a, b, b, a, ...) after one warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            times[k].append(time_ms(fns[k], reps, torch))
    return {k: statistics.median(v) for k, v in times.items()}


def profile_eval(flow, x, generator, card, torch):
    """Where the time of one eval batch goes.

    In one process, on the same batch: eval ms/batch by CUDA events (as
    phase 4 times it) and by the host clock with a sync at the end, in
    six turns of three batches each, to show how far they drift; then
    two batches under ``torch.profiler`` for device time, busy share,
    device ops and kernel launches; then one batch with a sync around every
    layer for the host-clock time by layer type (exclusive of nested
    layers). The profiler's table goes to ``chiprun_out/profile_eval.txt``.
    """
    from contextlib import ExitStack
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from inverse_flow_tpu_torch.layers.base import FlowLayer

    def batch():
        return flow.cheap_log_prob(x, generator)

    def wall_ms(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            batch()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    with torch.inference_mode():
        for _ in range(2):
            batch()
        # in turns, as the pass is host-bound and its time drifts
        events_ms, host_ms = [], []
        for _ in range(6):
            events_ms.append(time_ms(batch, 3, torch))
            host_ms.append(wall_ms(3))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms = wall_ms(2)
    for name, ms in (("CUDA events", events_ms), ("the host clock", host_ms)):
        print(f"profile: eval ms/batch by {name}, 6 rounds of 3 batches: "
              f"{', '.join(f'{t:.3f}' for t in ms)} (median "
              f"{statistics.median(ms):.3f}) {card}", flush=True)
    print(f"profile: eval {prof_ms:.3f} ms/batch under the profiler "
          f"(2 batches) {card}", flush=True)

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                  # union of device intervals, us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    avgs = prof.key_averages()
    launches = sum(e.count for e in avgs if e.key.startswith("cudaLaunch"))
    busy_ms = busy / 1e3 / 2
    print(f"profile: device busy {busy_ms:.3f} ms/batch of {prof_ms:.3f} "
          f"(idle share {1 - busy_ms / prof_ms:.3f}); {len(spans) / 2:.0f} "
          f"device ops and {launches / 2:.0f} kernel launch calls per "
          f"batch", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    print("profile: device ms/batch by op: " + ", ".join(
        f"{e.key} {e.self_device_time_total / 2e3:.3f} ({e.count // 2})"
        for e in ops), flush=True)
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_eval.txt"), "w") as f:
        f.write(f"{card} eval of one batch of {x.shape[0]}, 2 batches\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))

    by_type, nested = {}, []

    def timed(cls, fn):
        def wrapper(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nested.append(0.0)
            result = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            own = dt - nested.pop()
            by_type[cls.__name__] = by_type.get(cls.__name__, 0.0) + own
            if nested:
                nested[-1] += dt
            return result
        return wrapper

    # the unpatched methods first: a subclass may inherit its parent's
    originals = {type(m): type(m).forward_with for m in flow.modules()
                 if isinstance(m, FlowLayer)}
    with ExitStack() as stack, torch.inference_mode():
        for cls, fn in originals.items():
            stack.enter_context(mock.patch.object(cls, "forward_with",
                                                  timed(cls, fn)))
        batch()
    print("profile: host ms by layer type, one batch, synced: " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in sorted(
            by_type.items(), key=lambda kv: -kv[1])), flush=True)


def main():
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run "
             "needs a CUDA card")
    sys.path.insert(0, HERE)
    import inverse_flow_tpu_torch
    if os.path.dirname(os.path.abspath(inverse_flow_tpu_torch.__file__)) \
            != os.path.join(HERE, "inverse_flow_tpu_torch"):
        fail("inverse_flow_tpu_torch is not the checkout's own package")
    from inverse_flow_tpu_torch.data import mnist
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import _build, fused_chain
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.chain_solve_lib(dev.index)
    print(f"build: {os.path.relpath(_build.build('chain_solve'), HERE)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernel vs plain --------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)

    def operands(chw, orders):
        c = chw[0]
        x = torch.randn((BATCH,) + chw, generator=gen, device=dev)
        ws = tuple(apply_mask(0.1 * torch.randn(
            (c, c, 3, 3), generator=gen, device=dev)) for _ in orders)
        return fused_chain.chain_inputs(x, ws, orders)

    max_err = 0.0
    for chw, orders in KERNEL_CASES:
        args = operands(chw, orders)
        with torch.inference_mode():
            y = fused_chain.chain_phases(*args)
            torch.cuda.synchronize()
            ref = fused_chain.chain_phases_reference(*args)
        err = (y - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        max_err = max(max_err, err)
        print(f"kernel: ({BATCH},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: max_abs_err {err:.3e} (tol {tol:.3e})",
              flush=True)
        if not err <= tol:
            fail(f"chain kernel disagrees with its plain version at {chw} "
                 f"{orders}")

    kernel_ms, plain_ms = [], []
    for chw in FLAGSHIP_SHAPES:
        args = operands(chw, ("TL",))
        with torch.inference_mode():
            t = ab_ms({"kernel": lambda: fused_chain.chain_phases(*args),
                       "plain": lambda: fused_chain.chain_phases_reference(
                           *args)}, reps=200, rounds=6, torch=torch)
        kernel_ms.append(t["kernel"])
        plain_ms.append(t["plain"])
        print(f"kernel: ({BATCH},{','.join(map(str, chw))}) TL: kernel "
              f"{1e3 * t['kernel']:.2f} us, plain torch "
              f"{1e3 * t['plain']:.2f} us per call {card}", flush=True)

    # ---- 4. the slice ---------------------------------------------------
    flow = build_glow((1, 28, 28), step_kind="inv_conv_no_pad", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", n_bins=5,
                      tail_bound=20.0, generator=gen, device=dev)
    cfg = ExperimentConfig(name="2L-16K_IF_Glow_MNIST", batch_size=BATCH,
                           max_eval_ex=EVAL_EXAMPLES, seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=cfg.batch_size,
                                           seed=cfg.seed)
    for w in caught:
        print(f"data: {w.message}", flush=True)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    n_eval, seen = 0, 0
    for xb in val:
        n_eval, seen = n_eval + 1, seen + xb.shape[0]
        if seen >= EVAL_EXAMPLES:
            break
    first = next(iter(val))

    fused_chain.chain_phases.launches = 0
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    bpd = exp.to_bpd(logpx)
    # data init runs every block twice, as the JAX Flow.data_init does:
    # its step-by-step init pass, then the block's forward
    passes = 2 + n_eval
    print(f"slice: {cfg.name} {n_params} params, data init + eval over "
          f"{n_eval} batches of {BATCH}: log p(x) {logpx:.4f}, BPD "
          f"{bpd:.4f}", flush=True)
    print(f"slice: chain kernel launches {launches} for {passes} passes "
          f"through the blocks (2 for data init, 1 per eval batch; 32 "
          f"per pass)", flush=True)
    if not math.isfinite(bpd):
        fail("BPD is not finite")
    if launches != 32 * passes:
        fail(f"expected {32 * passes} chain kernel launches, got {launches}")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        z, lp = body(x + u)
        with mock.patch.object(fused_chain, "chain_phases",
                               fused_chain.chain_phases_reference):
            z_ref, lp_ref = body(x + u)
    rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    print(f"slice: log p(x) kernel vs plain chain on one batch, same noise: "
          f"max rel err {rel:.3e} (tol {LOGPX_RTOL:.0e}); z {tuple(z.shape)} "
          f"max abs diff {(z - z_ref).abs().max().item():.3e}", flush=True)
    if z.shape != (BATCH, 8, 7, 7) or not torch.isfinite(lp).all():
        fail("flow output has the wrong shape or is not finite")
    if not rel <= LOGPX_RTOL:
        fail("log p(x) through the kernel disagrees with the plain chain")

    def eval_batch():
        return flow.cheap_log_prob(x, exp.generator)

    def eval_batch_plain():
        with mock.patch.object(fused_chain, "chain_phases",
                               fused_chain.chain_phases_reference):
            return flow.cheap_log_prob(x, exp.generator)

    with torch.inference_mode():
        t = ab_ms({"kernel": eval_batch, "plain": eval_batch_plain},
                  reps=3, rounds=8, torch=torch)
    print(f"slice: eval {t['kernel']:.3f} ms/batch of {BATCH} (plain chain "
          f"{t['plain']:.3f} ms/batch) {card}", flush=True)

    # ---- 5. profile -----------------------------------------------------
    profile_eval(flow, x, exp.generator, card, torch)

    print(json.dumps({"kernels": [{
        "name": "chain_phases", "route": "cuda",
        "source": "inverse_flow_tpu_torch/csrc/chain_solve.cu",
        "replaces": "inverse_flow_tpu/ops/fused_chain.py:209",
        "launches": launches, "max_abs_err": max_err,
        # mean over the two flagship shapes, which the path launches
        # equally often
        "ms": statistics.fmean(kernel_ms),
        "plain_ms": statistics.fmean(plain_ms)}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
