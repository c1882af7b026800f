#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on three models at full width, random weights
from seed 0, batch 100:

* the flagship ``if_glow_mnist`` (L=2 blocks x K=16 steps of
  ``InvFlowNoPad``, coupling width 512, RQ spline 5 bins): scoring
  (``Experiment.maybe_data_init`` -> ``Flow.cheap_log_prob`` -> ``to_bpd``),
  sampling (``Flow.sample``: masked convs, no chain) and training (``maybe_data_init`` -> ``train_epoch`` -> ``train_step``:
  loss, backward, Adam with warmup and ExponentialLR, weight clamp 0.01);
* ``imagenet32`` (``bench.py``'s config: L=3 x K=48 ``InvFlowUnit``, the
  four-order chain, width 128, SLR; Adam lr 1e-5, no scheduler, no clamp)
  on synthetic (3, 32, 32) images: data init, eval, training;
* ``ff_glow_mnist`` (L=2 x K=16 ``FincFlowUnit``, width 512, RQ spline 5
  bins): data init, eval, sampling (``Flow.sample``,
  ``Experiment.sample``: FincFlow's level-2 inverse on the chain kernel)
  and training (grouped convs, no chain),

in phases:

  1. device: the card's name and power limit;
  2. build: the chain kernels from ``inverse_flow_tpu_torch/csrc``, each
     kernel's registers, shared memory and spills, and the cluster
     kernel's resident clusters at every main-path shape
     (:func:`print_build`);
  3. kernel: the kernel the dispatch picks (the cluster kernel at every
     main-path shape) against its plain PyTorch version on the card at
     the flagship's shapes (and both scan directions, the padded tail and
     a four-order chain), with its time beside the streaming kernel's
     (forced), the plain version's and the library call's
     (:func:`library_chain`), timed in turns with the device behind the
     host (:func:`time_launch`);
  4. backward: ``FusedChainSolve``'s dx and dW through the kernel against
     the same Function on the plain recurrence, at the kernel cases of
     phase 3; the backward's launch (BR, transposed kernel) timed against
     its plain version and the library call;
  5. slice: data init and eval over 3 validation batches, BPD, the kernel's
     launch count, log p(x) against the same model on the plain chain, and
     eval ms/batch;
  6. profile: where the time of one eval batch goes
     (:func:`profile_eval`); the flagship's ``Flow.sample`` of 100: no
     launch, finite samples, ms per 100 (:func:`flagship_sample`);
  7. train: data init and one epoch of 10 steps on the first 1,000
     synthetic training images with the registry's training config; every
     loss finite, the launch count, every weight within the clamp, the
     step-1 gradients against the plain chain, train ms/step against the
     plain chain, peak memory, and the device's time and launches per
     step (:func:`phase_train`);
  8. imagenet32: the four-order kernel, forward and backward, at the
     model's three solve shapes against its plain version and timed
     beside it and the library call; data init and one eval batch; one
     epoch of 3 steps with launch counts, losses, step-1 gradients, train
     ms/step, peak memory and a profiled step (:func:`phase_imagenet32`);
  9. ff: the kernel on FincFlow's expanded groups-4 kernel at its two
     shapes, B=100 and B=1, against its plain version and timed beside it,
     the library call and the bound; data init and one eval batch;
     ``Flow.sample`` (launches, finite samples, kernel vs plain chain on
     the same draws, round trips, ms per 100 images and per image, a
     profiled sample, host ms by layer type, peak memory) and
     ``Experiment.sample``; then 10 train steps with the registry's config
     and no launch (:func:`phase_ff`).

Every chain launch of the main paths must go to the cluster kernel
(:func:`cluster_only`). Every phase prints one line or more; the line
before the last is the kernel summary as JSON, the last ``{"ok": true,
"device": ...}``. Any
failed check exits non-zero with no result line. Without a CUDA card it
fails at once: nothing runs on the CPU. Float32 throughout, TF32 off for
matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import copy
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
# imagenet32: the InvFlowUnit solve shapes of its three levels, the unit's
# orders, and the examples of its train epoch (3 steps)
UNIT_SHAPES = [(12, 16, 16), (24, 8, 8), (48, 4, 4)]
UNIT = ("TL", "TR", "BL", "BR")
UNIT_TRAIN_EXAMPLES = 300
# |log p(x)| differences from summation order alone, float32, 38 layers
LOGPX_RTOL = 1e-4
# norm-relative differences of samples (before the final floor) and of
# inverse(forward(x)) round trips, float32 through up to 38 layers
SAMPLE_RTOL = 1e-4
# norm-relative gradient differences, kernel vs plain chain, float32
GRAD_RTOL = 1e-4
# the library call (cuBLAS trsm on the dense operator) against the kernel:
# another summation order over up to 3,072 terms per output, four solves
# chained; a gross-error check of the yardstick, not a parity bound
LIBRARY_RTOL = 1e-3
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps, torch, ahead=False):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events.
    ``ahead``: the device first sleeps for about ``reps`` x 50 us, so that
    the host queues the calls before the device reaches them and the
    events time the device's work, not the host's launch rate (a chain
    launch of 10-20 us takes about as long to enqueue)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(reps * 100_000)     # cycles, about 1.9 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(fns, reps, rounds, torch, ahead=False):
    """Median ms per call of each of ``fns`` (dict), timed in turns
    (a, b, b, a, ...) after one warm-up call each (``ahead``: see
    :func:`time_ms`)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            times[k].append(time_ms(fns[k], reps, torch, ahead))
    return {k: statistics.median(v) for k, v in times.items()}


def raster_perm(c, h, w, order, torch, device=None):
    """The NCHW-flattened indices of one image in ``order``'s raster
    order: rows of H (reversed when the order flips H), pixels of W
    (reversed when it flips W), channels innermost. In that order the
    order's masked conv is unit lower triangular."""
    from inverse_flow_tpu_torch.ops.fused_chain import ORDER_FLAGS

    fh, fw = ORDER_FLAGS[order]
    hh, ww, cc = (torch.arange(n, device=device) for n in (h, w, c))
    hh, ww = (hh.flip(0) if fh else hh), (ww.flip(0) if fw else ww)
    return ((cc[None, None, :] * h + hh[:, None, None]) * w
            + ww[None, :, None]).reshape(-1)


def library_chain(v, w_effs, orders, backward, torch):
    """The library call that computes the chain kernel's function: one
    ``torch.linalg.solve_triangular`` (cuBLAS trsm) per order on the dense
    (CHW, CHW) operator in that order's raster order, with a row gather
    between orders. Forward: ``y`` of the chain on ``v`` (B, C, H, W).
    ``backward``: the chain's transpose applied to the cotangent ``v``,
    the orders reversed, each ``upper=True`` on the transposed operator:
    the function of the backward's launch. The operators and the column
    layout (CHW, B) are built here, outside the timed call; returns the
    call, whose result :func:`from_columns` brings back to NCHW."""
    from inverse_flow_tpu_torch.ops.inv_conv import dense_operator

    b, c, h, w = v.shape
    tl = raster_perm(c, h, w, "TL", torch, v.device)
    steps = [(o, dense_operator(k, c, h, w)[tl][:, tl])
             for o, k in zip(orders, w_effs)]
    if backward:
        steps = [(o, m.T.contiguous()) for o, m in reversed(steps)]
    perms = [raster_perm(c, h, w, o, torch, v.device) for o, _ in steps]
    inverse = [torch.argsort(p) for p in perms]
    gathers = ([perms[0]] + [inverse[i - 1][perms[i]]
                             for i in range(1, len(perms))] + [inverse[-1]])
    mats = [m for _, m in steps]
    cols = v.detach().reshape(b, -1).T.contiguous()

    def call():
        z = cols[gathers[0]]
        for m, g in zip(mats, gathers[1:]):
            z = torch.linalg.solve_triangular(m, z, upper=backward,
                                              unitriangular=True)[g]
        return z
    return call


def from_columns(z, shape):
    """(CHW, B) columns -> (B, C, H, W)."""
    return z.T.reshape(shape)


def chain_bound(args, torch):
    """(bound_ms, bound_by, multiply-adds per batch row) of one
    :func:`chain_phases` launch on ``args``: the larger of the
    multiply-adds this launch's data needs at the fp32 peak, and its bytes
    at the HBM rate.

    Multiply-adds: at every block step, for each live output column, the
    nonzero entries of its row of T off the diagonal (T is a permuted unit
    triangle: the diagonal is a copy and the upper half is zero), and,
    after a scan's first block, of its row of G; each only over the live
    columns it multiplies (a padded tail column is always zero). Bytes: x
    read and every phase output written once, and the nonzero entries of T
    off the diagonal and of G read once."""
    xb, t_all, g_all, dirs, kcw, pad_cw = args
    nb, b, rcw = xb.shape
    t_nz = (t_all != 0) & ~torch.eye(rcw, dtype=torch.bool,
                                     device=t_all.device)
    g_nz = g_all != 0
    full = torch.ones(rcw, dtype=torch.bool, device=t_all.device)
    tail = torch.arange(rcw, device=t_all.device) < rcw - pad_cw
    fma = 0
    for o, flip_h in enumerate(dirs):
        prev = None
        for i in range(nb):
            m = nb - 1 - i if flip_h else i
            live = tail if m == nb - 1 else full
            fma += int(t_nz[o][live][:, live].sum())
            if prev is not None:
                carried = prev[:kcw] if flip_h else prev[rcw - kcw:]
                fma += int(g_nz[o][live][:, carried].sum())
            prev = live
    ops_ms = 2 * fma * b / PEAK_FP32_FLOPS * 1e3
    n_bytes = 4 * ((1 + len(dirs)) * xb.numel() + int(t_nz.sum())
                   + int(g_nz.sum()))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", fma
    return bytes_ms, "bytes", fma


def time_launch(x, ws, orders, backward, reps, rounds, torch):
    """One launch's function timed in turns on the same inputs, the device
    running behind the host (:func:`time_ms`): the kernel the dispatch
    picks (the cluster kernel at every shape of the main paths), the
    streaming kernel forced, the plain version and the library call; the
    streaming kernel checked against the plain version to ``1e-5 *
    max(1, max|y|)`` and the library result against the kernel's.
    ``backward``: the backward's launch on the cotangent ``x``
    (complementary orders, transposed kernels). Returns (times dict,
    :func:`chain_bound`'s triple, library max abs err)."""
    from inverse_flow_tpu_torch.ops import fused_chain

    make = fused_chain.backward_inputs if backward else \
        fused_chain.chain_inputs
    args = make(x, ws, orders)
    if fused_chain.chain_variant(args[0].shape[2], args[4]) != "cluster":
        fail(f"{tuple(x.shape)} {orders} does not dispatch to the cluster "
             f"kernel")
    library = library_chain(x, ws, orders, backward, torch)
    _, c, h, w = x.shape
    with torch.inference_mode():
        y = fused_chain._from_blocks_trim(fused_chain.chain_phases(
            *args)[-1], c, h, w)
        lib_err = (from_columns(library(), x.shape) - y).abs().max().item()
        if not lib_err <= LIBRARY_RTOL * max(1.0, y.abs().max().item()):
            fail(f"the library call disagrees with the kernel at "
                 f"{tuple(x.shape)} {orders} (backward {backward}): "
                 f"{lib_err}")
        ref = fused_chain.chain_phases_reference(*args)
        stream_err = (fused_chain.chain_phases(*args, variant="streaming")
                      - ref).abs().max().item()
        if not stream_err <= 1e-5 * max(1.0, ref.abs().max().item()):
            fail(f"the streaming kernel disagrees with its plain version at "
                 f"{tuple(x.shape)} {orders}: {stream_err}")
        t = ab_ms({"kernel": lambda: fused_chain.chain_phases(*args),
                   "streaming": lambda: fused_chain.chain_phases(
                       *args, variant="streaming"),
                   "plain": lambda: fused_chain.chain_phases_reference(
                       *args),
                   "library": library}, reps=reps, rounds=rounds,
                  torch=torch, ahead=True)
    return t, chain_bound(args, torch), lib_err


def solve_operands(chw, orders, gen, dev, torch):
    """A batch of 100 inputs (C, H, W) and one masked kernel per order,
    of std 0.1 / sqrt(C): at every case max|y| stays near 5 while the
    solves move y by a quarter to three fifths of |x|. (A std of 0.1
    at C >= 12 drives four chained solves to |y| of 1e3-1e4, which would
    loosen the ``1e-5 * max|y|`` limit as far.)"""
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    c = chw[0]
    x = torch.randn((BATCH,) + chw, generator=gen, device=dev)
    ws = [apply_mask(0.1 / math.sqrt(c) * torch.randn(
        (c, c, 3, 3), generator=gen, device=dev)) for _ in orders]
    return x, ws


def check_forward(cases, label, gen, dev, torch):
    """The kernel against its plain version on each case's launch, to
    ``1e-5 * max(1, max|y|)``; returns the largest error."""
    from inverse_flow_tpu_torch.ops import fused_chain

    max_err = 0.0
    for chw, orders in cases:
        args = fused_chain.chain_inputs(*solve_operands(chw, orders, gen,
                                                        dev, torch), orders)
        with torch.inference_mode():
            y = fused_chain.chain_phases(*args)
            torch.cuda.synchronize()
            ref = fused_chain.chain_phases_reference(*args)
        err = (y - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        max_err = max(max_err, err)
        print(f"{label}: ({BATCH},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: max_abs_err {err:.3e} (tol {tol:.3e})",
              flush=True)
        if not err <= tol:
            fail(f"chain kernel disagrees with its plain version at {chw} "
                 f"{orders}")
    return max_err


def check_backward(cases, label, gen, dev, torch):
    """``FusedChainSolve``'s dx and dW through the kernel (two launches)
    against the same Function on the plain recurrence, to ``1e-5 *
    max(1, max|dx|)`` and ``1e-4 * max|dW|``; returns the largest dx
    error, which is the backward launch's last phase."""
    from inverse_flow_tpu_torch.ops import fused_chain

    def vjp(x, ws, orders, gy):
        x = x.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in ws]
        y = fused_chain.fused_chain_solve(x, ws, orders)
        return torch.autograd.grad(y, [x, *ws], gy)

    max_err = 0.0
    for chw, orders in cases:
        x, ws = solve_operands(chw, orders, gen, dev, torch)
        gy = torch.randn(x.shape, generator=gen, device=dev)
        before = fused_chain.chain_phases.launches
        dx, *dws = vjp(x, ws, orders, gy)
        torch.cuda.synchronize()
        launched = fused_chain.chain_phases.launches - before
        with plain_chain(fused_chain):
            ref_dx, *ref_dws = vjp(x, ws, orders, gy)
        err = (dx - ref_dx).abs().max().item()
        tol = 1e-5 * max(1.0, ref_dx.abs().max().item())
        dw_rel = max(((d - r).abs().max() / r.abs().max()).item()
                     for d, r in zip(dws, ref_dws))
        max_err = max(max_err, err)
        print(f"{label}: ({BATCH},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: dx max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), dW max err / max|dW| {dw_rel:.3e} (tol 1e-4); "
              f"{launched} kernel launches", flush=True)
        if launched != 2:
            fail(f"expected 2 chain kernel launches (forward and backward) "
                 f"at {chw} {orders}, got {launched}")
        if not (err <= tol and dw_rel <= 1e-4):
            fail(f"the backward through the kernel disagrees with the plain "
                 f"chain at {chw} {orders}")
    return max_err


def time_rows(shapes, orders, backward, reps, rounds, label, gen, dev, card,
              torch):
    """The kernel, plain and library times of one launch at each shape,
    with the bound (:func:`time_launch`); returns their means over the
    shapes, which the path launches equally often."""
    rows = []
    for chw in shapes:
        x, ws = solve_operands(chw, orders, gen, dev, torch)
        t, (bound, bound_by, fma), lib_err = time_launch(
            x, ws, orders, backward, reps, rounds, torch)
        rows.append((t["kernel"], t["streaming"], t["plain"], t["library"],
                     bound))
        print(f"{label}: ({BATCH},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}{' backward launch' * backward}: "
              f"{launch_times(t, bound, bound_by, fma)}; library vs kernel "
              f"max abs diff {lib_err:.3e} {card}", flush=True)
    return mean_row(rows, bound_by)


def launch_times(t, bound, bound_by, fma):
    """One line's worth of :func:`time_launch`'s times and the bound."""
    return (f"cluster kernel {1e3 * t['kernel']:.2f} us, streaming kernel "
            f"{1e3 * t['streaming']:.2f} us, plain torch "
            f"{1e3 * t['plain']:.2f} us, library {1e3 * t['library']:.2f} "
            f"us per call; bound {1e3 * bound:.3f} us ({bound_by}, {fma} "
            f"multiply-adds per batch row; the cluster kernel at "
            f"{bound / t['kernel']:.3%} of it, the streaming kernel at "
            f"{bound / t['streaming']:.3%})")


def mean_row(rows, bound_by):
    """The summary entry's times: means over a path's launch shapes, which
    it launches equally often."""
    means = [statistics.fmean(col) for col in zip(*rows)]
    return dict(ms=means[0], streaming_ms=means[1], plain_ms=means[2],
                library_ms=means[3], bound_ms=means[4], bound_by=bound_by)


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
    host_by_layer(flow, "forward_with", batch, "eval batch", torch)


def host_by_layer(flow, method, fn, what, torch):
    """One call of ``fn`` with a sync around every layer's ``method``
    (``forward_with`` or ``inverse_with``): prints the host-clock ms by
    layer type, exclusive of nested layers."""
    from inverse_flow_tpu_torch.layers.base import FlowLayer

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
    originals = {type(m): getattr(type(m), method) for m in flow.modules()
                 if isinstance(m, FlowLayer)}
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for cls, orig in originals.items():
            stack.enter_context(mock.patch.object(cls, method,
                                                  timed(cls, orig)))
        fn()
    print(f"profile: host ms by layer type, one {what}, synced: " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in sorted(
            by_type.items(), key=lambda kv: -kv[1])), flush=True)


def plain_chain(fused_chain):
    """A context in which every solve runs the kernel's plain version."""
    return mock.patch.object(fused_chain, "chain_phases",
                             fused_chain.chain_phases_reference)


def cluster_only(what, launches):
    """Fails unless all ``launches`` chain launches since the last
    ``reset_launches`` went to the cluster kernel; returns the counts by
    variant."""
    from inverse_flow_tpu_torch.ops import fused_chain

    by = dict(fused_chain.chain_phases.launches_by_variant)
    if by["cluster"] != launches or sum(by.values()) != launches:
        fail(f"{what}: {launches} chain launches, by variant {by}: not all "
             f"on the cluster kernel")
    return by


def counted_epoch(exp, first, torch):
    """``maybe_data_init(first)`` and one ``train_epoch``, with the chain
    kernel's launch counts set to 0 just before and read just after; every
    launch must go to the cluster kernel. Returns (losses, mean loss,
    launches, backward launches, the state after data init)."""
    from inverse_flow_tpu_torch.ops import fused_chain

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
        fused_chain.reset_launches()
        exp.maybe_data_init(first)
        init_state = copy.deepcopy(exp.flow.state_dict())
        mean_loss = exp.train_epoch(1)
        torch.cuda.synchronize()
        launches = fused_chain.chain_phases.launches
    cluster_only(f"{exp.cfg.name} data init + epoch", launches)
    return [float(v) for v in losses], mean_loss, launches, bwd[0], init_state


def check_grads(label, flow, first, gen, dev, torch):
    """Step-1 gradients of -log p(x) after dequantization, through the
    kernel against the plain chain, on the same batch and noise."""
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import fused_chain

    body = Flow(flow.base_distribution, flow.layers[1:])
    params = list(body.parameters())
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)

    def grads():
        return torch.autograd.grad((-body(x + u)[1]).mean(), params)

    g_kernel = grads()
    with plain_chain(fused_chain):
        g_plain = grads()
    rel = max(0.0 if torch.equal(a, b) else
              ((a - b).norm() / b.norm()).item()
              for a, b in zip(g_kernel, g_plain))
    print(f"{label}: step-1 gradients kernel vs plain chain, same batch and "
          f"noise: max over {len(params)} tensors of |g - g_plain| / "
          f"|g_plain| {rel:.3e} (tol {GRAD_RTOL:.0e})", flush=True)
    if not rel <= GRAD_RTOL:
        fail("gradients through the kernel disagree with the plain chain")
    return x


def time_steps(label, exp, x, reps, rounds, card, torch):
    """Train ms/step through the kernel and the plain chain, in turns."""
    from inverse_flow_tpu_torch.ops import fused_chain

    def step():
        exp.train_step(x)

    def step_plain():
        with plain_chain(fused_chain):
            exp.train_step(x)

    t = ab_ms({"kernel": step, "plain": step_plain}, reps=reps,
              rounds=rounds, torch=torch)
    print(f"{label}: {t['kernel']:.3f} ms/step of {BATCH} (plain chain "
          f"{t['plain']:.3f} ms/step), CUDA events, median of {rounds} "
          f"turns of {reps} steps {card}", flush=True)
    return step


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
    from inverse_flow_tpu_torch.data import ArrayLoader, mnist
    from inverse_flow_tpu_torch.models.glow import build_glow
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

    values, mean_loss, launches, bwd, init_state = counted_epoch(
        exp, first, torch)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    w_max = max(p.detach().abs().max().item() for p in flow.parameters())
    print(f"train: {cfg.name} data init + {len(values)} steps of {BATCH} "
          f"(lr {cfg.lr}, warmup {cfg.warmup_epochs} epoch, "
          f"{cfg.scheduler_name} {cfg.gamma}, clamp {cfg.weight_clamp}): "
          f"losses {', '.join(f'{v:.4f}' for v in values)}; mean "
          f"{mean_loss:.4f}", flush=True)
    print(f"train: chain kernel launches {launches} ({launches - bwd} "
          f"forward, {bwd} backward) for data init + {steps} steps "
          f"(32 x 2 + 64 per step); max |weight| {w_max:.6f}; Batch Time "
          f"Mean {exp.batch_time.mean:.3f} ms over the epoch's window; "
          f"peak memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"expected {steps} finite training losses, got {values}")
    if launches != 32 * 2 + 64 * steps or bwd != 32 * steps:
        fail(f"expected {32 * 2 + 64 * steps} chain kernel launches "
             f"({32 * steps} backward), got {launches} ({bwd})")
    if not w_max <= cfg.weight_clamp * (1 + 1e-6):
        fail(f"a weight exceeds the clamp: {w_max}")

    flow.load_state_dict(init_state)
    x = check_grads("train", flow, first, gen, dev, torch)
    step = time_steps("train", exp, x, 2, 6, card, torch)
    device_profile("train", "step", step, 2, card, torch)
    return launches - bwd, bwd


def phase_imagenet32(dev, gen, card, torch):
    """Phase 8: ``bench.py``'s ``imagenet32`` config, L=3 x K=48
    ``InvFlowUnit`` (144 four-order solves per pass), width 128, SLR,
    batch 100, on synthetic (3, 32, 32) images through
    ``data/imagenet.py``; random weights from seed 0.

    The four-order kernel at the model's three solve shapes, forward and
    backward, against its plain version, timed beside it and the library
    call; data init and one eval batch (144 launches per pass, finite BPD,
    log p(x) against the plain chain); data init and one epoch of 3 steps
    with the ``imagenet32`` training config (Adam lr 1e-5, no warmup, no
    scheduler, no clamp): every loss finite, ``144 x 2 + 288 x steps``
    launches of which ``144 x steps`` backward, step-1 gradients against
    the plain chain, train ms/step against the plain chain, peak memory,
    and one profiled step. Returns the forward and backward kernel rows
    of the summary line."""
    from inverse_flow_tpu_torch.data import ArrayLoader, imagenet
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label = "imagenet32"
    on = dict(gen=gen, dev=dev, torch=torch)
    cases = [(chw, UNIT) for chw in UNIT_SHAPES]
    errs = (check_forward(cases, f"{label}: kernel", **on),
            check_backward(cases, f"{label}: backward", **on))
    rows = [dict(time_rows(UNIT_SHAPES, UNIT, backward, 5, 4, label,
                           card=card, **on), max_abs_err=err)
            for backward, err in ((False, errs[0]), (True, errs[1]))]

    def model():
        gen = torch.Generator(dev).manual_seed(0)
        return build_glow((3, 32, 32), step_kind="inv_flow_unit",
                          num_blocks=3, block_size=48, coupling_width=128,
                          actnorm=True, split_prior=True, activation="SLR",
                          generator=gen, device=dev), gen

    cfg = ExperimentConfig(
        name="imagenet32", lr=1e-5, batch_size=BATCH, warmup_epochs=0,
        scheduler_name="None", weight_clamp=None, add_recon_grad=False,
        max_eval_ex=BATCH, metrics_path=os.path.join(
            HERE, "chiprun_out", "imagenet32_metrics.jsonl"), seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train, val, test = imagenet.load_data(size=32, batch_size=BATCH,
                                              seed=cfg.seed)
    for w in caught:
        print(f"{label}: data: {w.message}", flush=True)
    train = ArrayLoader(train.data[:UNIT_TRAIN_EXAMPLES], BATCH,
                        shuffle=True, seed=cfg.seed)
    first = train.data[:BATCH]

    # scoring: data init and one eval batch
    flow, gen = model()
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    fused_chain.reset_launches()
    t0 = time.perf_counter()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} data init + eval", launches)
    bpd = exp.to_bpd(logpx)
    print(f"{label}: {n_params} params, data init + eval over 1 batch of "
          f"{BATCH}: log p(x) {logpx:.4f}, BPD {bpd:.4f}; chain kernel "
          f"launches {launches} for 3 passes (144 per pass); {host_s:.1f} s",
          flush=True)
    if not math.isfinite(bpd):
        fail("imagenet32 BPD is not finite")
    if launches != 144 * 3:
        fail(f"expected {144 * 3} chain kernel launches, got {launches}")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        z, lp = body(x + u)
        with plain_chain(fused_chain):
            z_ref, lp_ref = body(x + u)
    rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    print(f"{label}: log p(x) kernel vs plain chain on one batch, same "
          f"noise: max rel err {rel:.3e} (tol {LOGPX_RTOL:.0e}); z "
          f"{tuple(z.shape)} max abs diff "
          f"{(z - z_ref).abs().max().item():.3e}", flush=True)
    if z.shape != (BATCH, 48, 4, 4) or not torch.isfinite(lp).all():
        fail("imagenet32 output has the wrong shape or is not finite")
    if not rel <= LOGPX_RTOL:
        fail("imagenet32 log p(x) through the kernel disagrees with the "
             "plain chain")

    def eval_batch():
        return flow.cheap_log_prob(x, exp.generator)

    def eval_batch_plain():
        with plain_chain(fused_chain):
            return flow.cheap_log_prob(x, exp.generator)

    with torch.inference_mode():
        t = ab_ms({"kernel": eval_batch, "plain": eval_batch_plain},
                  reps=1, rounds=4, torch=torch)
    print(f"{label}: eval {t['kernel']:.3f} ms/batch of {BATCH} (plain "
          f"chain {t['plain']:.3f} ms/batch), median of 4 turns {card}",
          flush=True)
    del exp, flow, body, z, z_ref
    torch.cuda.empty_cache()

    # training: data init and one epoch
    flow, gen = model()
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    steps = len(train)
    values, mean_loss, launches, bwd, init_state = counted_epoch(
        exp, first, torch)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    print(f"{label}: data init + {len(values)} steps of {BATCH} (Adam lr "
          f"{cfg.lr}, no warmup, no scheduler, no clamp): losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; mean {mean_loss:.4f}",
          flush=True)
    print(f"{label}: chain kernel launches {launches} ({launches - bwd} "
          f"forward, {bwd} backward) for data init + {steps} steps "
          f"(144 x 2 + 288 per step); Batch Time Mean "
          f"{exp.batch_time.mean:.3f} ms over the epoch's window; peak "
          f"memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"expected {steps} finite imagenet32 losses, got {values}")
    if launches != 144 * 2 + 288 * steps or bwd != 144 * steps:
        fail(f"expected {144 * 2 + 288 * steps} chain kernel launches "
             f"({144 * steps} backward), got {launches} ({bwd})")

    flow.load_state_dict(init_state)
    x = check_grads(label, flow, first, gen, dev, torch)
    step = time_steps(label, exp, x, 1, 4, card, torch)
    device_profile(label, "step", step, 1, card, torch)
    return [dict(r, launches=n) for r, n in zip(rows,
                                                 (launches - bwd, bwd))]


def grouped_operands(chw, b, gen, dev, torch):
    """``b`` inputs (C, H, W) and the kernel of a ``FincFlowUnit`` inverse:
    four (C/4, C/4, 3, 3) chunk kernels of the model's init scale
    (normal(0, 0.05)), masked and expanded into one dense block-diagonal
    kernel, as ``layers/padded_conv.py`` does."""
    from inverse_flow_tpu_torch.ops.fused_chain import expand_grouped_kernel
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    c = chw[0]
    x = torch.randn((b,) + chw, generator=gen, device=dev)
    w_eff = torch.cat([apply_mask(0.05 * torch.randn(
        (c // 4, c // 4, 3, 3), generator=gen, device=dev))
        for _ in range(4)])
    return x, [expand_grouped_kernel(w_eff, 4)]


def grouped_rows(gen, dev, card, torch):
    """FincFlow's level-2 launch (N=1 TL on the expanded groups-4 kernel)
    at its two shapes, at the sample batch and at one image: the kernel
    against its plain version to ``1e-5 * max(1, max|y|)``, then its time
    beside the plain version's, the library call's and the bound (which
    counts nonzero products: the zero blocks lower the kernel's share of
    it). Returns the summary entry (times at B=100, means over the shapes)
    without its launch count."""
    from inverse_flow_tpu_torch.ops import fused_chain

    max_err, rows = 0.0, []
    for b in (BATCH, 1):
        for chw in FLAGSHIP_SHAPES:
            x, ws = grouped_operands(chw, b, gen, dev, torch)
            args = fused_chain.chain_inputs(x, ws, ("TL",))
            with torch.inference_mode():
                y = fused_chain.chain_phases(*args)
                torch.cuda.synchronize()
                ref = fused_chain.chain_phases_reference(*args)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * max(1.0, ref.abs().max().item())
            max_err = max(max_err, err)
            if not err <= tol:
                fail(f"the grouped chain kernel disagrees with its plain "
                     f"version at {b} x {chw}: {err} > {tol}")
            t, (bound, bound_by, fma), lib_err = time_launch(
                x, ws, ("TL",), False, 100, 4, torch)
            if b == BATCH:
                rows.append((t["kernel"], t["streaming"], t["plain"],
                             t["library"], bound))
            print(f"ff: kernel ({b},{','.join(map(str, chw))}) groups-4 TL: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}); "
                  f"{launch_times(t, bound, bound_by, fma)}; library vs "
                  f"kernel max abs diff {lib_err:.3e} {card}", flush=True)
    return dict(mean_row(rows, bound_by), max_abs_err=max_err)


def sample_noise(flow, n, gen, dev, torch):
    """Draws for ``flow.layers[1:]`` (the flow without its
    Dequantization) as ``Flow.sample`` takes them: z from the base and
    each SplitPrior's factored-out half, keyed by its index there."""
    from inverse_flow_tpu_torch.layers import SplitPrior

    noise = {"base": torch.randn((n,) + tuple(flow.base_distribution.size),
                                 generator=gen, device=dev)}
    for i, layer in enumerate(flow.layers[1:]):
        if isinstance(layer, SplitPrior):
            noise[i] = torch.randn((n,) + tuple(layer.base.size),
                                   generator=gen, device=dev)
    return noise


def block_magnitudes(flow, noise, torch):
    """One ``Flow.sample`` on ``noise`` with max|z| taken after every
    layer's inverse. Returns [(layer type, max|z|)] in sampling order."""
    from inverse_flow_tpu_torch.layers import Flow

    seen = []

    def recorded(layer):
        inverse = layer.inverse

        def wrapper(*args, **kwargs):
            z = inverse(*args, **kwargs)
            seen.append((type(layer).__name__, z.abs().max().item()))
            return z
        return wrapper

    body = Flow(flow.base_distribution, flow.layers[1:])
    with contextlib.ExitStack() as stack:
        for layer in body.layers:
            stack.enter_context(mock.patch.object(layer, "inverse",
                                                  recorded(layer)))
        body.sample(noise["base"].shape[0], noise=noise)
    return seen


def flagship_sample(flow, gen, card, torch):
    """The flagship's ``Flow.sample`` of 100 images: no chain launch (its
    inverse is the masked conv), finite samples, ms per 100."""
    from inverse_flow_tpu_torch.ops import fused_chain

    fused_chain.reset_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    t = ab_ms({"sample": lambda: flow.sample(BATCH, gen)}, reps=1, rounds=4,
              torch=torch)
    print(f"sample: flagship Flow.sample of {BATCH}: {launches} chain kernel "
          f"launches, values {x.min().item():.0f}..{x.max().item():.0f}; "
          f"{t['sample']:.3f} ms per {BATCH} images, median of 4 {card}",
          flush=True)
    if launches != 0 or x.shape != (BATCH, 1, 28, 28) \
            or not torch.isfinite(x).all():
        fail("the flagship's samples launched the chain or are not finite")


def phase_ff(dev, gen, card, torch):
    """Phase 9: ``ff_glow_mnist`` as the registry builds it
    (``inverse_flow_tpu/experiments/registry.py:197-206``): L=2 x K=16
    ``FincFlowUnit``, width 512, RQ spline 5 bins, batch 100, random
    weights from seed 0, synthetic MNIST. Its training forward is a
    grouped masked conv; its inverse, the sampling direction, is FincFlow's
    level 2 on the chain kernel: 32 launches per ``Flow.sample``.

    The grouped launch against its plain version and timed
    (:func:`grouped_rows`); data init and one eval batch (no launch);
    sampling on the data-initialised model at its init scale: one
    ``Flow.sample`` with its launches counted and max|z| after every layer,
    ``Experiment.sample`` (100 one-image samples, then 100 images and
    their grid), kernel vs plain chain on the same draws before the final
    floor, each RepeatedBlock's and one FincFlowUnit's round trip, sample
    ms per 100 images and per image against the plain chain, a profiled
    sample, the host ms by layer type of one sample, and peak memory;
    then one epoch of 10 train steps with the registry's config: no
    launch, finite losses, weights within the clamp, ms/step. Returns the
    summary entry, its launches those of one ``Flow.sample``."""
    from inverse_flow_tpu_torch.data import ArrayLoader, mnist
    from inverse_flow_tpu_torch.layers import Flow, RepeatedBlock
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label, t_phase = "ff", time.perf_counter()
    row = grouped_rows(gen, dev, card, torch)

    gen = torch.Generator(dev).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="ff", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", generator=gen,
                      device=dev)
    out = os.path.join(HERE, "chiprun_out")
    cfg = ExperimentConfig(
        name="2L-16K FF Glow MNIST", lr=1e-5, batch_size=BATCH,
        modified_grad=True, add_recon_grad=True, sym_recon_grad=True,
        recon_loss_weight=10.0, weight_clamp=0.01, scheduler_name="None",
        max_eval_ex=BATCH, sample_dir=os.path.join(out, "samples_ff"),
        metrics_path=os.path.join(out, "ff_metrics.jsonl"), seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=BATCH, seed=cfg.seed)
    train = ArrayLoader(train.data[:TRAIN_EXAMPLES], BATCH, shuffle=True,
                        seed=cfg.seed)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    first = train.data[:BATCH]

    fused_chain.reset_launches()
    exp.maybe_data_init(first)
    bpd = exp.to_bpd(exp.eval_epoch(val))
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    print(f"{label}: {cfg.name} {n_params} params, data init + eval over 1 "
          f"batch of {BATCH}: BPD {bpd:.4f}; chain kernel launches "
          f"{launches} (the forward is a grouped conv)", flush=True)
    if not math.isfinite(bpd) or launches:
        fail(f"ff scoring: BPD {bpd}, {launches} chain launches")

    # ---- sampling, the main path: counts set to 0 just before ----------
    torch.cuda.reset_peak_memory_stats(dev)
    fused_chain.reset_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    sample_launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Flow.sample", sample_launches)
    print(f"{label}: Flow.sample of {BATCH}: {sample_launches} chain kernel "
          f"launches (one per FincFlowUnit: 16 + 16); values "
          f"{x.min().item():.0f}..{x.max().item():.0f}", flush=True)
    if sample_launches != 32:
        fail(f"expected 32 chain kernel launches per Flow.sample, got "
             f"{sample_launches}")
    if x.shape != (BATCH, 1, 28, 28) or not torch.isfinite(x).all():
        fail("ff samples have the wrong shape or are not finite")

    noise = sample_noise(flow, BATCH, gen, dev, torch)
    mags = block_magnitudes(flow, noise, torch)
    print(f"{label}: max|z| after each layer's inverse, in sampling order: "
          + ", ".join(f"{name} {m:.4g}" for name, m in mags), flush=True)

    body = Flow(flow.base_distribution, flow.layers[1:])
    y = body.sample(BATCH, noise=noise)
    with plain_chain(fused_chain):
        y_ref = body.sample(BATCH, noise=noise)
    rel = ((y - y_ref).norm() / y_ref.norm()).item()
    print(f"{label}: samples before the floor, kernel vs plain chain on the "
          f"same draws: |y - y_plain| / |y_plain| {rel:.3e} (tol "
          f"{SAMPLE_RTOL:.0e}); max abs diff "
          f"{(y - y_ref).abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(y).all() and rel <= SAMPLE_RTOL):
        fail("ff samples through the kernel disagree with the plain chain")

    with torch.inference_mode():
        xb = torch.as_tensor(first, device=dev)
        h = xb + torch.rand(xb.shape, generator=gen, device=dev)
        trips = []
        for layer in flow.layers[1:]:
            if isinstance(layer, RepeatedBlock):
                z = layer(h)[0]
                trips.append(((layer.inverse(z) - h).norm()
                              / h.norm()).item())
                if len(trips) == 1:
                    unit, p = layer.steps[1], layer._step_params(0)[1]
                    u = torch.randn(h.shape, generator=gen, device=dev)
                    unit_trip = ((unit.inverse_with(p, unit.forward_with(
                        p, u)[0]) - u).norm() / u.norm()).item()
            h = layer(h)[0]
    print(f"{label}: round trips |inverse(forward(x)) - x| / |x|: "
          f"RepeatedBlocks {', '.join(f'{r:.3e}' for r in trips)}; one "
          f"FincFlowUnit {unit_trip:.3e} (tol {SAMPLE_RTOL:.0e})", flush=True)
    if not max(trips + [unit_trip]) <= SAMPLE_RTOL:
        fail("an ff inverse does not undo its forward")

    t = ab_ms({"kernel": lambda: flow.sample(BATCH, gen),
               "plain": lambda: plain_sample(flow, BATCH, gen)},
              reps=1, rounds=4, torch=torch)
    t1 = ab_ms({"kernel": lambda: flow.sample(1, gen),
                "plain": lambda: plain_sample(flow, 1, gen)},
               reps=1, rounds=4, torch=torch)
    print(f"{label}: Flow.sample {t['kernel']:.3f} ms per {BATCH} images "
          f"(plain chain {t['plain']:.3f}), {t1['kernel']:.3f} ms per image "
          f"at n=1 (plain chain {t1['plain']:.3f}), CUDA events, medians of "
          f"4 turns {card}", flush=True)
    busy, calls = device_profile("sample_ff", "Flow.sample",
                                 lambda: flow.sample(BATCH, gen), 2, card,
                                 torch)
    host_by_layer(flow, "inverse_with", lambda: flow.sample(BATCH, gen),
                  f"Flow.sample of {BATCH}", torch)

    fused_chain.reset_launches()
    samples = exp.sample(1)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Experiment.sample", launches)
    n_one = max(5, min(cfg.n_samples, 100))
    png = os.path.join(cfg.sample_dir, "1.png")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{label}: Experiment.sample: Sample Time Mean "
          f"{exp.sample_time.mean:.3f} ms, Std {exp.sample_time.std:.3f} ms "
          f"(the middle {n_one - 2 * (n_one // 5)} of {n_one} one-image "
          f"samples); {launches} chain kernel launches (32 x {n_one + 2}); "
          f"grid {os.path.relpath(png, HERE)}; peak memory while sampling "
          f"{peak_gb:.3f} GB {card}", flush=True)
    if launches != 32 * (n_one + 2) or not os.path.exists(png) \
            or not torch.isfinite(samples).all():
        fail(f"Experiment.sample: {launches} launches, grid written "
             f"{os.path.exists(png)}")

    # ---- training: FincFlow's forward reaches no chain ------------------
    values, mean_loss, launches, bwd, _ = counted_epoch(exp, first, torch)
    w_max = max(p.detach().abs().max().item() for p in flow.parameters())
    xb = torch.as_tensor(first, device=dev)
    ts = ab_ms({"step": lambda: exp.train_step(xb)}, reps=2, rounds=4,
               torch=torch)
    print(f"{label}: {len(values)} steps of {BATCH} (Adam lr {cfg.lr}, "
          f"warmup {cfg.warmup_epochs} epochs, no scheduler, clamp "
          f"{cfg.weight_clamp}, recon weight {cfg.recon_loss_weight} and no "
          f"recon layer): losses {', '.join(f'{v:.4f}' for v in values)}; "
          f"chain kernel launches {launches}; max |weight| {w_max:.6f}; "
          f"{ts['step']:.3f} ms/step, median of 4 turns of 2 {card}",
          flush=True)
    if len(values) != len(train) or not all(map(math.isfinite, values)):
        fail(f"expected {len(train)} finite ff losses, got {values}")
    if launches or bwd:
        fail(f"ff training launched the chain kernel {launches} times")
    if not w_max <= cfg.weight_clamp * (1 + 1e-6):
        fail(f"an ff weight exceeds the clamp: {w_max}")
    print(f"{label}: per Flow.sample of {BATCH}: device busy {busy:.3f} ms, "
          f"{calls:.0f} kernel launch calls, {sample_launches} chain "
          f"launches; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(row, launches=sample_launches)


def print_build(dev, _build, fused_chain):
    """Phase 2's report: each kernel's registers, shared memory and spills
    as ``ptxas -v`` gave them; and, at every solve shape of the main paths
    at batch 100 and 1, the cluster kernel's shared memory and how many of
    its clusters can be resident at once against the ceil(B / 8) a launch
    needs (one wave when they all fit)."""
    for line in _build.build_log("chain_solve").splitlines():
        if "Compiling entry" in line:
            name = "cluster" if "cluster_kernel" in line else "streaming"
        elif "registers" in line or "spill" in line:
            print(f"build: {name} kernel: {line.strip()}", flush=True)
    for rcw, kcw in ((392, 112), (336, 112), (384, 384)):
        for b in (BATCH, 1):
            active = _build.cluster_occupancy(dev.index, b, rcw, kcw)
            need = -(-b // fused_chain.CLUSTER_ROWS)
            print(f"build: cluster kernel at RCW={rcw} KCW={kcw} B={b}: "
                  f"{fused_chain.cluster_smem_bytes(rcw, kcw)} bytes of "
                  f"shared memory a CTA; {active} clusters of "
                  f"{fused_chain.CLUSTER_SIZE} resident at once, {need} "
                  f"needed: {'one wave' if need <= active else 'waves'}",
                  flush=True)


def plain_sample(flow, n, gen):
    """``flow.sample`` with every solve on the kernel's plain version."""
    from inverse_flow_tpu_torch.ops import fused_chain

    with plain_chain(fused_chain):
        return flow.sample(n, gen)


def main():
    import torch

    t_start = time.perf_counter()

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
    print_build(dev, _build, fused_chain)

    # ---- 3. kernel vs plain --------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    on = dict(gen=gen, dev=dev, torch=torch)
    max_err = check_forward(KERNEL_CASES, "kernel", **on)
    fwd_times = time_rows(FLAGSHIP_SHAPES, ("TL",), False, 200, 6, "kernel",
                          card=card, **on)

    # ---- 4. backward vs plain ------------------------------------------
    bwd_err = check_backward(KERNEL_CASES, "backward", **on)
    # the backward's launch of a TL solve: BR, transposed kernel
    bwd_times = time_rows(FLAGSHIP_SHAPES, ("TL",), True, 200, 6,
                          "backward", card=card, **on)

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

    fused_chain.reset_launches()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only("slice data init + eval", launches)
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
        with plain_chain(fused_chain):
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
        with plain_chain(fused_chain):
            return flow.cheap_log_prob(x, exp.generator)

    with torch.inference_mode():
        t = ab_ms({"kernel": eval_batch, "plain": eval_batch_plain},
                  reps=3, rounds=8, torch=torch)
    print(f"slice: eval {t['kernel']:.3f} ms/batch of {BATCH} (plain chain "
          f"{t['plain']:.3f} ms/batch) {card}", flush=True)

    # ---- 6. profile -----------------------------------------------------
    profile_eval(flow, x, exp.generator, card, torch)
    flagship_sample(flow, gen, card, torch)

    # ---- 7. train -------------------------------------------------------
    fwd_launches, bwd_launches = phase_train(dev, card, torch)

    # ---- 8. imagenet32 --------------------------------------------------
    unit_rows = phase_imagenet32(dev, gen, card, torch)

    # ---- 9. ff ----------------------------------------------------------
    grouped_row = phase_ff(dev, gen, card, torch)

    print(f"smoke: phases 1-9 in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    def entry(name, launches, **row):
        # every main-path launch went to the cluster kernel (cluster_only)
        return dict(name=name, route="cuda", variant="cluster",
                    source="inverse_flow_tpu_torch/csrc/chain_solve.cu",
                    replaces="inverse_flow_tpu/ops/fused_chain.py:209",
                    launches=launches, launches_by_variant={
                        "cluster": launches, "streaming": 0}, **row)

    # times and bounds: means over each path's solve shapes, which it
    # launches equally often (ms: the cluster kernel, streaming_ms: the
    # streaming kernel forced); launches: each path's train run (phases 7
    # and 8, the counts set to 0 just before), and for the grouped launch
    # one Flow.sample of ff_glow_mnist (phase 9)
    print(json.dumps({"kernels": [
        entry("chain_phases", fwd_launches, max_abs_err=max_err,
              **fwd_times),
        entry("chain_phases:backward", bwd_launches, max_abs_err=bwd_err,
              **bwd_times),
        entry("chain_phases:unit", **unit_rows[0]),
        entry("chain_phases:unit_backward", **unit_rows[1]),
        entry("chain_phases:grouped", **grouped_row)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
