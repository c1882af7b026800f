#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths on the flagship model ``if_glow_mnist`` at
full width (L=2 blocks x K=16 steps, coupling width 512, RQ spline 5 bins,
batch 100; random weights from seed 0): scoring (``Experiment.
maybe_data_init`` -> ``Flow.cheap_log_prob`` -> ``to_bpd``) and training
(``maybe_data_init`` -> ``train_epoch`` -> ``train_step``: loss, backward,
Adam with warmup and ExponentialLR, weight clamp 0.01), in phases:

  1. device: the card's name and power limit;
  2. build: the chain kernel from ``inverse_flow_tpu_torch/csrc``;
  3. kernel: the kernel against its plain PyTorch version on the card at
     the main path's shapes (and both scan directions, the padded tail and
     a four-order chain), with its time beside the plain version's;
  4. backward: ``FusedChainSolve``'s dx and dW through the kernel against
     the same Function on the plain recurrence, at the kernel cases of
     phase 3; the backward's launch (BR, transposed kernel) timed against
     its plain version;
  5. slice: data init and eval over 3 validation batches, BPD, the kernel's
     launch count, log p(x) against the same model on the plain chain, and
     eval ms/batch;
  6. profile: where the time of one eval batch goes
     (:func:`profile_eval`);
  7. train: data init and one epoch of 10 steps on the first 1,000
     synthetic training images with the registry's training config; every
     loss finite, the launch count, every weight within the clamp, the
     step-1 gradients against the plain chain, train ms/step against the
     plain chain, peak memory, and the device's time and launches per
     step (:func:`phase_train`).

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
EVAL_EXAMPLES = 300
TRAIN_EXAMPLES = 1000
# the main path's solve shapes (C, H, W), and the kernel cases: both scan
# directions, the padded tail of (8, 7, 7), and a four-order chain
FLAGSHIP_SHAPES = [(4, 14, 14), (8, 7, 7)]
KERNEL_CASES = [((4, 14, 14), ("TL",)), ((8, 7, 7), ("TL",)),
                ((8, 7, 7), ("BR",)), ((4, 14, 14), ("TL", "TR", "BL", "BR"))]
# |log p(x)| differences from summation order alone, float32, 38 layers
LOGPX_RTOL = 1e-4
# norm-relative gradient differences, kernel vs plain chain, float32
GRAD_RTOL = 1e-4


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


def device_profile(name, unit, fn, n, card, torch):
    """``n`` calls of ``fn`` under ``torch.profiler``: host ms per call,
    device busy ms (the union of device intervals), idle share, device
    ops, kernel launch calls, and device ms by op, per ``unit``; the
    profiler's table goes to ``chiprun_out/profile_<name>.txt``. Returns
    (busy ms, launches) per call."""
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                  # union of device intervals, us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    avgs = prof.key_averages()
    launches = sum(e.count for e in avgs if e.key.startswith("cudaLaunch"))
    busy_ms = busy / 1e3 / n
    print(f"profile: {name} device busy {busy_ms:.3f} ms/{unit} of "
          f"{prof_ms:.3f} (idle share {1 - busy_ms / prof_ms:.3f}); "
          f"{len(spans) / n:.0f} device ops and {launches / n:.0f} kernel "
          f"launch calls per {unit} {card}", flush=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile: {name} device ms/{unit} by op: " + ", ".join(
        f"{e.key} {e.self_device_time_total / n / 1e3:.3f} ({e.count // n})"
        for e in ops), flush=True)
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{name}.txt"), "w") as f:
        f.write(f"{card} {name}, {n} calls at batch {BATCH}\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    return busy_ms, launches / n


def profile_eval(flow, x, generator, card, torch):
    """Where the time of one eval batch goes.

    In one process, on the same batch: eval ms/batch by CUDA events (as
    phase 5 times it) and by the host clock with a sync at the end, in
    six turns of three batches each, to show how far they drift; then
    two batches under ``torch.profiler`` for device time, busy share,
    device ops and kernel launches; then one batch with a sync around every
    layer for the host-clock time by layer type (exclusive of nested
    layers). The profiler's table goes to ``chiprun_out/profile_eval.txt``.
    """
    from contextlib import ExitStack

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
    for name, ms in (("CUDA events", events_ms), ("the host clock", host_ms)):
        print(f"profile: eval ms/batch by {name}, 6 rounds of 3 batches: "
              f"{', '.join(f'{t:.3f}' for t in ms)} (median "
              f"{statistics.median(ms):.3f}) {card}", flush=True)
    with torch.inference_mode():
        device_profile("eval", "batch", batch, 2, card, torch)

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


def phase_train(dev, card, torch):
    """Phase 7: the flagship's training path, ``maybe_data_init`` and one
    ``train_epoch`` of 10 steps, with the registry's training config
    (``inverse_flow_tpu/experiments/registry.py:145-151``). Checks every
    loss finite, ``32 x 2 + 64 x steps`` kernel launches (data init passes
    every block twice; a step runs each of the 32 solves forward and
    backward), every weight within the clamp, and the step-1 gradients
    through the kernel against the plain chain; prints train ms/step
    against the plain chain, peak memory, and the device's busy time and
    launches per step. Returns the main path's (forward, backward)
    launches."""
    import copy

    from inverse_flow_tpu_torch.data import ArrayLoader, mnist
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    gen = torch.Generator(dev).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="inv_conv_no_pad", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", n_bins=5,
                      tail_bound=20.0, generator=gen, device=dev)
    cfg = ExperimentConfig(
        name="2L-16K_IF_Glow_MNIST", lr=1e-5, batch_size=BATCH, epochs=2000,
        warmup_epochs=1, gamma=0.96170, scheduler_name="ExponentialLR",
        grad_clip_norm=None, weight_clamp=0.01, modified_grad=True,
        add_recon_grad=True, sym_recon_grad=True, recon_loss_weight=0.0,
        sample_true_inv=True, eval_train=True,
        metrics_path=os.path.join(HERE, "chiprun_out", "train_metrics.jsonl"),
        seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=BATCH, seed=cfg.seed)
    train = ArrayLoader(train.data[:TRAIN_EXAMPLES], BATCH, shuffle=True,
                        seed=cfg.seed)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    steps = len(train)
    first = train.data[:BATCH]

    # the step's losses, and the launches its backward passes make
    losses, bwd = [], [0]
    step_fn = exp.train_step
    solve_bwd = fused_chain.FusedChainSolve.backward

    def recorded_step(xb):
        losses.append(step_fn(xb))
        return losses[-1]

    def counted_backward(ctx, gy):
        before = fused_chain.chain_phases.launches
        out = solve_bwd(ctx, gy)
        bwd[0] += fused_chain.chain_phases.launches - before
        return out

    with mock.patch.object(exp, "train_step", recorded_step), \
            mock.patch.object(fused_chain.FusedChainSolve, "backward",
                              staticmethod(counted_backward)):
        fused_chain.chain_phases.launches = 0
        exp.maybe_data_init(first)
        init_state = copy.deepcopy(flow.state_dict())
        mean_loss = exp.train_epoch(1)
        torch.cuda.synchronize()
        launches = fused_chain.chain_phases.launches
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    values = [float(v) for v in losses]
    w_max = max(p.detach().abs().max().item() for p in flow.parameters())
    print(f"train: {cfg.name} data init + {len(values)} steps of {BATCH} "
          f"(lr {cfg.lr}, warmup {cfg.warmup_epochs} epoch, "
          f"{cfg.scheduler_name} {cfg.gamma}, clamp {cfg.weight_clamp}): "
          f"losses {', '.join(f'{v:.4f}' for v in values)}; mean "
          f"{mean_loss:.4f}", flush=True)
    print(f"train: chain kernel launches {launches} ({launches - bwd[0]} "
          f"forward, {bwd[0]} backward) for data init + {steps} steps "
          f"(32 x 2 + 64 per step); max |weight| {w_max:.6f}; Batch Time "
          f"Mean {exp.batch_time.mean:.3f} ms over the epoch's window; "
          f"peak memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"expected {steps} finite training losses, got {values}")
    if launches != 32 * 2 + 64 * steps or bwd[0] != 32 * steps:
        fail(f"expected {32 * 2 + 64 * steps} chain kernel launches "
             f"({32 * steps} backward), got {launches} ({bwd[0]})")
    if not w_max <= cfg.weight_clamp * (1 + 1e-6):
        fail(f"a weight exceeds the clamp: {w_max}")

    # step-1 gradients, kernel vs plain chain, same batch and noise
    flow.load_state_dict(init_state)
    body = Flow(flow.base_distribution, flow.layers[1:])
    params = list(body.parameters())
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)

    def grads():
        return torch.autograd.grad((-body(x + u)[1]).mean(), params)

    g_kernel = grads()
    with mock.patch.object(fused_chain, "chain_phases",
                           fused_chain.chain_phases_reference):
        g_plain = grads()
    rel = max(0.0 if torch.equal(a, b) else
              ((a - b).norm() / b.norm()).item()
              for a, b in zip(g_kernel, g_plain))
    print(f"train: step-1 gradients kernel vs plain chain, same batch and "
          f"noise: max over {len(params)} tensors of |g - g_plain| / "
          f"|g_plain| {rel:.3e} (tol {GRAD_RTOL:.0e})", flush=True)
    if not rel <= GRAD_RTOL:
        fail("gradients through the kernel disagree with the plain chain")

    def step():
        exp.train_step(x)

    def step_plain():
        with mock.patch.object(fused_chain, "chain_phases",
                               fused_chain.chain_phases_reference):
            exp.train_step(x)

    t = ab_ms({"kernel": step, "plain": step_plain}, reps=2, rounds=6,
              torch=torch)
    print(f"train: {t['kernel']:.3f} ms/step of {BATCH} (plain chain "
          f"{t['plain']:.3f} ms/step), CUDA events, median of 6 turns of 2 "
          f"steps {card}", flush=True)
    device_profile("train", "step", step, 2, card, torch)
    return launches - bwd[0], bwd[0]


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

    def solve_operands(chw, orders):
        c = chw[0]
        x = torch.randn((BATCH,) + chw, generator=gen, device=dev)
        ws = [apply_mask(0.1 * torch.randn(
            (c, c, 3, 3), generator=gen, device=dev)) for _ in orders]
        return x, ws

    def operands(chw, orders, transpose=False):
        x, ws = solve_operands(chw, orders)
        ws = [w.transpose(0, 1) if transpose else w for w in ws]
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

    # ---- 4. backward vs plain ------------------------------------------
    def vjp(x, ws, orders, gy):
        x = x.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in ws]
        y = fused_chain.fused_chain_solve(x, ws, orders)
        return torch.autograd.grad(y, [x, *ws], gy)

    bwd_err = 0.0
    for chw, orders in KERNEL_CASES:
        x, ws = solve_operands(chw, orders)
        gy = torch.randn(x.shape, generator=gen, device=dev)
        before = fused_chain.chain_phases.launches
        dx, *dws = vjp(x, ws, orders, gy)
        torch.cuda.synchronize()
        launched = fused_chain.chain_phases.launches - before
        with mock.patch.object(fused_chain, "chain_phases",
                               fused_chain.chain_phases_reference):
            ref_dx, *ref_dws = vjp(x, ws, orders, gy)
        err = (dx - ref_dx).abs().max().item()
        tol = 1e-5 * max(1.0, ref_dx.abs().max().item())
        dw_rel = max(((d - r).abs().max() / r.abs().max()).item()
                     for d, r in zip(dws, ref_dws))
        bwd_err = max(bwd_err, err)
        print(f"backward: ({BATCH},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: dx max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), dW max err / max|dW| {dw_rel:.3e} (tol 1e-4); "
              f"{launched} kernel launches", flush=True)
        if launched != 2:
            fail(f"expected 2 chain kernel launches (forward and backward) "
                 f"at {chw} {orders}, got {launched}")
        if not (err <= tol and dw_rel <= 1e-4):
            fail(f"the backward through the kernel disagrees with the plain "
                 f"chain at {chw} {orders}")

    bwd_ms, bwd_plain_ms = [], []
    for chw in FLAGSHIP_SHAPES:
        args = operands(chw, ("BR",), transpose=True)
        with torch.inference_mode():
            t = ab_ms({"kernel": lambda: fused_chain.chain_phases(*args),
                       "plain": lambda: fused_chain.chain_phases_reference(
                           *args)}, reps=200, rounds=6, torch=torch)
        bwd_ms.append(t["kernel"])
        bwd_plain_ms.append(t["plain"])
        print(f"backward: ({BATCH},{','.join(map(str, chw))}) BR, transposed "
              f"kernel (the backward's launch): kernel "
              f"{1e3 * t['kernel']:.2f} us, plain torch "
              f"{1e3 * t['plain']:.2f} us per call {card}", flush=True)

    # ---- 5. the slice ---------------------------------------------------
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

    # ---- 6. profile -----------------------------------------------------
    profile_eval(flow, x, exp.generator, card, torch)

    # ---- 7. train -------------------------------------------------------
    fwd_launches, bwd_launches = phase_train(dev, card, torch)

    kernel = {"route": "cuda",
              "source": "inverse_flow_tpu_torch/csrc/chain_solve.cu",
              "replaces": "inverse_flow_tpu/ops/fused_chain.py:209"}
    # times: means over the two flagship shapes, which the path launches
    # equally often; launches: the train path's run (phase 7)
    print(json.dumps({"kernels": [
        dict(name="chain_phases", **kernel, launches=fwd_launches,
             max_abs_err=max_err, ms=statistics.fmean(kernel_ms),
             plain_ms=statistics.fmean(plain_ms)),
        dict(name="chain_phases:backward", **kernel,
             launches=bwd_launches, max_abs_err=bwd_err,
             ms=statistics.fmean(bwd_ms),
             plain_ms=statistics.fmean(bwd_plain_ms))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
