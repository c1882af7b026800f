#!/usr/bin/env python3
"""Where a block step of the chain's cluster kernels spends its time.

    python3 scripts/chain_step_profile.py          # the cluster kernel
    python3 scripts/chain_step_profile.py --wide   # the wide cluster kernel

Needs a CUDA card and ``nvcc``. Builds ``inverse_flow_tpu_torch/csrc/
chain_solve.cu`` with ``-DCHAIN_STEP_PROFILE`` into ``build/kernels/``
(the package's own build never defines it), launches the cluster kernel
at the main paths' solve shapes with random operands from seed 0, and
prints for each shape: device us per launch (CUDA events, the device
running behind the host), the max abs error against the plain version,
and the SM cycles of each part of a block step, as thread 0 of the first
CTA saw them (means over the first steps of the phases / the other
steps), with the card's name and power limit and its SM clock.

``--wide``: the wide cluster kernel at the two wide blocks of
``chip_smoke.py`` (W1 at B=128, W2 at B=100 and 56), built to stream
chunks of 64, 128 and 256 k-columns only (the package's build takes the
widest that fits): its plan (row groups, chunk buffers, chunk width,
resident clusters), us per launch, and per step
the cycles of the carry gather, the wait for the input rows, the tiles
(of which waiting for chunks, multiplying, and the per-chunk fence,
barrier and refill) and the cluster barrier.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (C, H, W), orders, batch: the flagship's and ff's N=1 solves, the
# imagenet32 unit's three levels, and one image
CASES = [((4, 14, 14), ("TL",), 100), ((8, 7, 7), ("TL",), 100),
         ((12, 16, 16), ("TL", "TR", "BL", "BR"), 100),
         ((24, 8, 8), ("TL", "TR", "BL", "BR"), 100),
         ((48, 4, 4), ("TL", "TR", "BL", "BR"), 100),
         ((4, 14, 14), ("TL",), 1)]
PARTS = ["stage", "gather", "wait+sync", "multiply-add", "reduce",
         "sum+store", "barrier"]


# the wide kernel's cases: name, (C, H, W), kernel size, batch
WIDE_CASES = [("W1", (1, 4160, 1), (2, 2), 128),
              ("W2", (12, 32, 32), (3, 3), 100),
              ("W2", (12, 32, 32), (3, 3), 56)]
WIDE_CHUNKS = (64, 128, 256)
WIDE_PARTS = ["gather", "rows wait+sync", "tiles", "barrier"]


def build_profiled(_build, defines=()):
    src = os.path.join(_build.CSRC, "chain_solve.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    tag = "".join(d.replace("-D", "_").replace("=", "") for d in defines)
    out = os.path.join(_build.BUILD_DIR,
                       f"libchain_solve_profile{tag}_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DCHAIN_STEP_PROFILE", *defines, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.chain_phases_init.argtypes = []
    for fn in (lib.chain_phases_cluster_f32,
               lib.chain_phases_cluster_wide_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    lib.chain_phases_cluster_wide_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.chain_step_clock_copy.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    if lib.chain_phases_init() != 0:
        raise RuntimeError("chain_phases_init failed")
    return lib


def timed(launch, torch, reps):
    """Device us per launch, the device running behind the host."""
    launch()
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * 100_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def stamps(lib, steps):
    import numpy as np

    out = (ctypes.c_longlong * (1024 * 8))()
    if lib.chain_step_clock_copy(out) != 0:
        raise RuntimeError("chain_step_clock_copy failed")
    return np.array(out[:steps * 8], np.float64).reshape(steps, 8)


def profile_wide(card, torch):
    from inverse_flow_tpu_torch.ops import _build, fused_chain
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    stream = torch.cuda.current_stream().cuda_stream
    for chunk in WIDE_CHUNKS:
        lib = build_profiled(_build, (f"-DWIDE_CHUNK={chunk}",))
        gen = torch.Generator("cuda").manual_seed(0)
        for name, chw, kernel, b in WIDE_CASES:
            c = chw[0]
            x = torch.randn((b,) + chw, generator=gen, device="cuda")
            ws = [apply_mask(0.1 / c ** 0.5 * torch.randn(
                (c, c) + kernel, generator=gen, device="cuda"))]
            xb, t, g, dirs, kcw, pad = fused_chain.chain_inputs(
                x, ws, ("TL",))
            nb, _, rcw = xb.shape
            y = torch.empty((1, nb, b, rcw), device="cuda")
            plan = (ctypes.c_int * 6)()
            if lib.chain_phases_cluster_wide_plan(b, rcw, kcw, plan):
                raise RuntimeError("chain_phases_cluster_wide_plan failed")

            def launch():
                err = lib.chain_phases_cluster_wide_f32(
                    xb.data_ptr(), t.data_ptr(), g.data_ptr(), y.data_ptr(),
                    1, nb, b, rcw, kcw, pad, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")

            us = timed(launch, torch, 20)
            err = (y - fused_chain.chain_phases_reference(
                xb, t, g, dirs, kcw, pad)).abs().max().item()
            a = stamps(lib, nb)
            d = a[:, 1:5] - a[:, 0:4]
            parts = ", ".join(f"{p} {d[1:, k].mean():.0f}"
                              for k, p in enumerate(WIDE_PARTS))
            print(f"wide {name} ({b},{','.join(map(str, chw))}) chunk "
                  f"{chunk}: plan groups {plan[0]}, chunk buffers "
                  f"{plan[1]} of {plan[2]}, {plan[3]} bytes, {plan[4]} "
                  f"clusters resident, {plan[5]} needed; {us:.2f} us per "
                  f"launch, "
                  f"max abs err {err:.2e}; SM cycles per step after the "
                  f"first: {parts}; in the tiles: chunk wait "
                  f"{a[1:, 5].mean():.0f}, multiply {a[1:, 6].mean():.0f}, "
                  f"fence+sync+refill {a[1:, 7].mean():.0f}; step "
                  f"{(a[1:, 4] - a[1:, 0]).mean():.0f} [{card}]",
                  flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chain_step_profile: needs a CUDA card")
    sys.path.insert(0, HERE)
    from inverse_flow_tpu_torch.ops import _build, fused_chain
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"SM clock now, max: {clocks} [{card}]", flush=True)
    if "--wide" in sys.argv[1:]:
        profile_wide(card, torch)
        return
    lib = build_profiled(_build)
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for chw, orders, b in CASES:
        c = chw[0]
        x = torch.randn((b,) + chw, generator=gen, device="cuda")
        ws = [apply_mask(0.1 / c ** 0.5 * torch.randn(
            (c, c, 3, 3), generator=gen, device="cuda")) for _ in orders]
        xb, t, g, dirs, kcw, pad = fused_chain.chain_inputs(x, ws, orders)
        nb, _, rcw = xb.shape
        n = len(dirs)
        y = torch.empty((n, nb, b, rcw), device="cuda")

        def launch():
            err = lib.chain_phases_cluster_f32(
                xb.data_ptr(), t.data_ptr(), g.data_ptr(), y.data_ptr(), n,
                nb, b, rcw, kcw, pad,
                sum(1 << o for o, d in enumerate(dirs) if d), stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        launch()
        torch.cuda.synchronize()
        reps = 50
        torch.cuda._sleep(reps * 100_000)   # the host runs ahead
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        us = 1e3 * start.elapsed_time(end) / reps
        err = (y - fused_chain.chain_phases_reference(
            xb, t, g, dirs, kcw, pad)).abs().max().item()
        stamps = (ctypes.c_longlong * (1024 * 8))()
        if lib.chain_step_clock_copy(stamps) != 0:
            raise RuntimeError("chain_step_clock_copy failed")
        steps = n * nb
        a = np.array(stamps[:steps * 8], np.float64).reshape(steps, 8)
        d = np.diff(a, axis=1)
        first = np.arange(steps) % nb == 0

        def mean(rows, k):
            return f"{d[rows, k].mean():.0f}" if rows.any() else "-"

        parts = ", ".join(f"{p} {mean(first, k)}/{mean(~first, k)}"
                          for k, p in enumerate(PARTS))
        print(f"({b},{','.join(map(str, chw))}) N={n}, {steps} block "
              f"steps: {us:.2f} us per launch, max abs err {err:.2e}; SM "
              f"cycles per step, first of a phase / others: {parts}; "
              f"step mean {(a[:, 7] - a[:, 0]).mean():.0f} cycles [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
