"""Benchmark entry point of the port: the train step of ``bench.py``'s
configurations on one CUDA card.

    python -m inverse_flow_tpu_torch.bench                    # the flagship
    python -m inverse_flow_tpu_torch.bench --config imagenet32
    python -m inverse_flow_tpu_torch.bench --all

With no argument it prints one JSON line, the contract of the JAX
package's ``bench.py`` (``:410-418``): ``{"metric": "glow_mnist_train_step",
"value": <ms>, "unit": "ms/batch", "vs_baseline": null, "extra": {...}}``.
``--config NAME`` prints that configuration's row; ``--all`` prints a row
for each of the ten names and writes them to
``chiprun_out/bench_sweep.jsonl``.

The timed step is the JAX bench's ``_make_train_scan.one_step``
(``bench.py:143-178``): ``synthetic.smooth_images(batch, size)``, the
flow's data init on that batch, then -mean log p(x), its backward and one
``torch.optim.Adam(lr=1e-5)`` update (``optax.adam(1e-5)``: no warmup,
scheduler or clamp). Seed 0, float32, TF32 off for matmuls and cuDNN; the
bf16 configurations keep their bf16 coupling nets.

Timing: CUDA events, where the JAX bench took the slope of an in-program
scan (a TPU backend's barrier fault that the events do not have): 2
warm-up steps, then ``ROUNDS`` rounds of a few steps, each round between
two events on the current stream and ended by a synchronize, so the
host's launch gaps count as they do for a user. ``train_step_ms`` is the
median of the rounds' ms per step. Sample latency is the reference's
per-image convention (``bench.py:181-199``): ``Flow.sample(1)`` draws,
each timed alone, the median after 2 warm-up draws. One more step under
the profiler gives the device's busy time, idle share and launch calls,
and one under ``FlopCounterMode`` the step's FLOPs (:func:`step_flops`).

Nothing runs on the CPU unless the caller asks for it
(``bench_config(..., device="cpu")``, as the tests do); there the times
are the host clock's and no device number is filled in.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial
from unittest import mock

import torch

from .data import synthetic
from .experiments import bench_configs
from .ops import coupling_net, fused_chain
from .utils import profiling

CONFIGS = bench_configs.CONFIGS
FLAGSHIP = "glow_mnist"
LR = 1e-5
WARMUP_STEPS = 2
ROUNDS = 5
# steps a round: about a second or more of host-bound steps, fewer at the
# large batches (the JAX bench's _K_PAIRS: 4-20 steps, 2-10 at B=1024,
# 1-5 at B=4096)
STEPS = 3
STEPS_BY_CONFIG = {"imagenet32_b1024": 2, "imagenet32_b4096": 1}
SAMPLE_WARMUP = 2
SAMPLE_DRAWS = 20
# dense bf16 peak by device name (NVIDIA's data sheet, the SXM part at
# 700 W), the yardstick of the MFU; an unknown card gets none
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}
METHODOLOGY = "cuda-events(median of turns), tf32 off"
FLOPS_METHOD = ("FlopCounterMode over one step (a checkpointed step's "
                "recompute included) + 2 x chain_work multiply-adds x batch "
                "a chain launch + the F.conv2d composition's FLOPs a "
                "coupling-net kernel call")
# the checkout's own output directory, whatever the working directory
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chiprun_out")
SWEEP = os.path.join(OUT_DIR, "bench_sweep.jsonl")


def train_step_fn(flow, x, generator, lr=LR):
    """The JAX bench's ``one_step`` on ``x``: -mean log p(x) (the
    dequantization noise from ``generator``), its backward and one Adam
    step over the learnable parameters. Returns ``step()``, which does one
    and returns the loss as a 0-d device tensor."""
    params = [p for p in flow.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -flow(x, generator)[1].mean()
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def step_flops(step):
    """(FLOPs, chain FLOPs, chain launches) of one call of ``step``:
    ``FlopCounterMode``'s count of the torch ops (convolutions and their
    gradients, the operator build's ``bmm``), where every
    ``fused_chain.chain_phases`` launch counts 2 x ``chain_work``'s
    multiply-adds x batch and nothing of what runs inside it, so that the
    count is the same whichever chain runs (the kernel, which the counter
    cannot see, or the plain chain's matmuls). Likewise a coupling net's
    kernel call (``coupling_net``'s forward or backward, which the counter
    cannot see either) counts what the counter counts of the ``F.conv2d``
    composition it replaces (``coupling_net.composition_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    chain = fused_chain.chain_phases
    net_fwd, net_bwd = coupling_net._forward, coupling_net._backward
    seen = {"inside": 0, "chain": 0, "launches": 0, "nets": 0}

    def inside(fn, *args):
        before = counter.get_total_flops()
        y = fn(*args)
        seen["inside"] += counter.get_total_flops() - before
        return y

    def counted(*args, **kwargs):
        y = inside(partial(chain, **kwargs), *args)
        seen["chain"] += 2 * fused_chain.chain_work(args)[0] * \
            args[0].shape[1]
        seen["launches"] += 1
        return y

    def counted_net_fwd(x1, w1, w2):
        seen["nets"] += coupling_net.composition_flops(x1, w1, w2)[0]
        return inside(net_fwd, x1, w1, w2)

    def counted_net_bwd(x1, w1, w2, g, need_dx):
        seen["nets"] += coupling_net.composition_flops(x1, w1, w2,
                                                       need_dx)[1]
        return inside(net_bwd, x1, w1, w2, g, need_dx)

    with mock.patch.object(fused_chain, "chain_phases", counted), \
            mock.patch.object(coupling_net, "_forward", counted_net_fwd), \
            mock.patch.object(coupling_net, "_backward", counted_net_bwd), \
            counter:
        step()
    total = (counter.get_total_flops() - seen["inside"] + seen["chain"]
             + seen["nets"])
    return total, seen["chain"], seen["launches"]


def power_limit_w():
    """CUDA card 0's power limit in W, as ``nvidia-smi
    --query-gpu=name,power.limit`` gives it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(smi.rsplit(",", 1)[1].split()[0])


def _clock_ms(fn, reps, cuda):
    """ms per call of ``reps`` calls: CUDA events on the card, the host
    clock on the CPU (whose ops are synchronous)."""
    if cuda:
        return profiling.time_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def bench_config(name, device="cuda", rounds=ROUNDS, steps=None,
                 draws=SAMPLE_DRAWS, **overrides):
    """One row of the bench for config ``name``: train ms/step (the
    median of ``rounds`` rounds of ``steps`` steps), sample ms per image
    (the median of ``draws`` draws), FLOPs, MFU, set-up seconds, device
    busy time, launches and peak memory, on ``device`` (the card unless
    the caller names another), with TF32 off for matmuls and cuDNN.
    ``overrides`` go to the model's build function (``num_blocks``,
    ``block_size``, ``coupling_width``). A loss that is not finite gives
    a row with ``error`` and no time."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    steps = steps or STEPS_BY_CONFIG.get(name, STEPS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        kind, power_w = torch.cuda.get_device_name(device), power_limit_w()
    else:
        kind, power_w = "cpu", None

    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(0)
    flow, shape, batch = bench_configs.build(name, device, gen, **overrides)
    x = torch.as_tensor(synthetic.smooth_images(batch, shape),
                        device=device)
    flow.data_init(x, gen)
    step = train_step_fn(flow, x, gen)
    losses = [step() for _ in range(WARMUP_STEPS)]
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def timed():
        losses.append(step())

    fused_chain.reset_launches()
    turns = [_clock_ms(lambda: [timed() for _ in range(steps)], 1, cuda)
             / steps for _ in range(rounds)]
    launched = {k: v // (rounds * steps) for k, v in
                fused_chain.chain_phases.launches_by_variant.items()}
    peak_gb = (torch.cuda.max_memory_allocated(device) / 2 ** 30
               if cuda else None)
    loss = torch.stack(losses)
    row = {"config": name, "batch_size": batch, "device": kind,
           "power_limit_w": power_w}
    if not torch.isfinite(loss).all():
        return dict(row, train_step_ms=None, losses=loss.tolist(),
                    error=f"a training loss is not finite: {loss.tolist()}")
    ms = statistics.median(turns)

    busy = idle = calls = None
    if cuda:
        busy, calls, idle = profiling.device_profile(
            f"bench_{name}", "step", step, 1, f"[{kind}, {power_w} W]",
            OUT_DIR)
    flops, chain_flops, chain_launches = step_flops(step)

    samples, draws_ms = [], []

    def draw():
        samples.append(flow.sample(1, gen))

    for i in range(SAMPLE_WARMUP + draws):
        t = _clock_ms(draw, 1, cuda)
        if i >= SAMPLE_WARMUP:
            draws_ms.append(t)
    sample_finite = all(bool(torch.isfinite(s).all()) for s in samples)

    peak = PEAK_TFLOPS.get(kind)
    achieved = flops / (ms * 1e-3) / 1e12
    return dict(
        row,
        train_step_ms=round(ms, 3),
        train_step_ms_turns=[round(t, 3) for t in turns],
        turns=[rounds, steps],
        loss=round(float(loss[-1]), 4),
        sample_latency_ms_per_image=round(statistics.median(draws_ms), 3),
        sample_finite=sample_finite,
        samples_per_sec_per_chip=round(batch / (ms * 1e-3), 1),
        train_step_gflops=round(flops / 1e9, 3),
        chain_gflops=round(chain_flops / 1e9, 3),
        achieved_tflops=achieved,
        mfu_pct_of_bf16_peak=100 * achieved / peak if peak else None,
        roofline_compute_bound_ms=(flops / (peak * 1e12) * 1e3 if peak
                                   else None),
        peak_tflops_assumed=peak,
        methodology=(METHODOLOGY if cuda else
                     "host clock(median of turns), tf32 off"),
        flops_methodology=FLOPS_METHOD,
        setup_s=round(setup_s, 3),
        device_busy_ms=None if busy is None else round(busy, 3),
        idle_share=None if idle is None else round(idle, 3),
        launch_calls=None if calls is None else round(calls),
        chain_launches_by_variant=launched,
        chain_calls_per_step=chain_launches,
        peak_memory_gb=None if peak_gb is None else round(peak_gb, 3))


def parser():
    ap = argparse.ArgumentParser(
        prog="python -m inverse_flow_tpu_torch.bench",
        description="Train step time of bench.py's configurations on one "
                    "CUDA card.")
    ap.add_argument("--all", action="store_true",
                    help="every config, one row each -> "
                         "chiprun_out/bench_sweep.jsonl")
    ap.add_argument("--config", choices=list(CONFIGS), default=None,
                    help="one config's row")
    return ap


def _flagship_line(row):
    line = {"metric": f"{FLAGSHIP}_train_step",
            "value": row.get("train_step_ms"), "unit": "ms/batch",
            "vs_baseline": None}
    if row.get("error"):
        line["error"] = row["error"]
    line["extra"] = {k: v for k, v in row.items()
                     if k not in ("config", "train_step_ms", "error")}
    return line


def main(argv=None):
    args = parser().parse_args(argv)
    names = (list(CONFIGS) if args.all else
             [args.config] if args.config else None)
    if not torch.cuda.is_available():
        error = ("no CUDA card: torch.cuda.is_available() is False; the "
                 "bench runs on the card only")
        if names is None:
            print(json.dumps(_flagship_line({"error": error})), flush=True)
        else:
            for name in names:
                print(json.dumps({"config": name, "train_step_ms": None,
                                  "error": error}), flush=True)
        sys.exit(1)

    if names is None:
        line = _flagship_line(bench_config(FLAGSHIP))
        print(json.dumps(line), flush=True)
        sys.exit(1 if "error" in line else 0)

    if args.all:
        os.makedirs(OUT_DIR, exist_ok=True)
        open(SWEEP, "w").close()
    failed = False
    for name in names:
        row = bench_config(name)
        failed = failed or "error" in row
        print(json.dumps(row), flush=True)
        if args.all:
            with open(SWEEP, "a") as f:
                f.write(json.dumps(row) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
