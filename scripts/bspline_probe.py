#!/usr/bin/env python3
"""What the B-spline inverse kernel's time is made of, on the card.

    python3 scripts/bspline_probe.py ablation   # the kernel's design choices
    python3 scripts/bspline_probe.py host       # the wrapper's host time
    python3 scripts/bspline_probe.py sample A B # phase 17 of two checkouts

Needs a CUDA card and ``nvcc``.

``ablation`` builds ``inverse_flow_tpu_torch/csrc/bspline_inverse.cu``
three ways into ``build/kernels/probe/``: as it is; with every coefficient
set unrolled to 16 bins (no 8-bin build); and with the set preparation in
float instead of double. It launches each through its C interface (no
wrapper) at the main shapes, B=100 and 1, 8 bins (5 for the B-spline
Glow's shape), y uniform in [0, 1], coefficients at std 0.5 from seed 0,
and prints us per launch (CUDA events, the device running behind the
host, medians of turns), the max abs error of x against the plain
version, and each kernel's registers.

``host`` times the wrapper ``ops.bspline.bspline_inverse`` in each layout
at B=100: the host's us a call (200 calls, no synchronisation), and the
kernel's us per launch by ``chip_smoke.time_ms`` with its sleep-ahead as
it is and four times as long: where the host's time a call passes the
sleep's share of a call (about 50 us), the timing reads the host.

``sample A B`` runs ``chip_smoke.phase_bspline_glow`` from the checkouts
A and B in turns (A, B, B, A), each in its own process: the B-spline
Glow's ``Flow.sample`` of 100, its ms and launch calls, as phase 17
prints them.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "inverse_flow_tpu_torch", "csrc",
                   "bspline_inverse.cu")
OUT = os.path.join(HERE, "build", "kernels", "probe")


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return f"[{smi}]"


def variants():
    """name -> source text of each build the ablation times."""
    src = open(SRC).read()
    one_bucket = src.replace("  if (bins <= 8) return launch<8>(a, s);\n",
                             "")
    start = src.index("template <int B>\nstruct Set {")
    end = src.index("// The root t in [0, 1]")
    prep = src[start:end].replace("double", "float")
    float_prep = (src[:start] + prep + src[end:]).replace(
        "const double yw = fma(static_cast<double>(yc), s.span, s.w[0]);",
        "const float yw = fmaf(yc, s.span, s.w[0]);")
    assert one_bucket != src and "double" not in prep
    return {"as_is": src, "one_bucket": one_bucket, "float_prep": float_prep}


def build(name, text):
    from inverse_flow_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True, check=True)
    return lib, done.stderr


def ablation(torch):
    import chip_smoke as cs
    from inverse_flow_tpu_torch.ops import bspline as ob

    texts = variants()
    with ThreadPoolExecutor() as pool:
        built = dict(zip(texts, pool.map(build, texts, texts.values())))
    fns = {}
    for name, (lib, log) in built.items():
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("_kernel")[0].split("bspline_")[-1]
                bucket = "<8>" if "ILi8E" in line else "<16>" if \
                    "ILi16E" in line else ""
            elif "registers" in line:
                print(f"{name}: {kernel}{bucket}: {line.strip()}",
                      flush=True)
        fn = ctypes.CDLL(lib).bspline_inverse_f32
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 5
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    tag = card()
    for b in (100, 1):
        for layout, shape, k in (("shared", (b, 12, 16, 16), 8),
                                 ("shared", (b, 4, 14, 14), 5),
                                 ("channels", (b, 6, 16, 16), 8),
                                 ("last", (b, 12, 16, 16), 8)):
            y = torch.rand(shape, generator=gen, device=dev)
            c_shape = {"shared": (k + 3,),
                       "channels": (b, shape[1] * (k + 3)) + shape[2:],
                       "last": shape + (k + 3,)}[layout]
            c = 0.5 * torch.randn(c_shape, generator=gen, device=dev)
            bins, inner = ob._layout(y, c, layout)
            x_ref, _ = ob.bspline_inverse_reference(y, c, layout)
            calls, errs = {}, {}
            for name, fn in fns.items():
                x, ld = torch.empty_like(y), torch.empty_like(y)
                stream = torch.cuda.current_stream().cuda_stream

                def call(fn=fn, x=x, ld=ld):
                    err = fn(y.data_ptr(), c.data_ptr(), x.data_ptr(),
                             ld.data_ptr(), None, y.numel(), bins, inner,
                             y.numel(), y.numel(), 0.0, 1.0, 1.0, 0.0, 1.0,
                             0, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                errs[name] = (x - x_ref).abs().max().item()
                calls[name] = call
            t = cs.ab_ms(calls, reps=50, rounds=6, ahead=True)
            print(f"ablation {layout} {shape} K={k}: " + ", ".join(
                f"{n} {1e3 * t[n]:.2f} us (err {errs[n]:.1e})"
                for n in calls) + f" {tag}", flush=True)


def host(torch):
    import chip_smoke as cs
    from inverse_flow_tpu_torch.ops import bspline as ob

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    tag = card()
    sleep = torch.cuda._sleep
    for layout, shape in (("shared", (100, 12, 16, 16)),
                          ("channels", (100, 6, 16, 16)),
                          ("channels", (100, 12, 8, 8)),
                          ("last", (100, 12, 16, 16))):
        y = torch.rand(shape, generator=gen, device=dev)
        c_shape = {"shared": (11,),
                   "channels": (100, shape[1] * 11) + shape[2:],
                   "last": shape + (11,)}[layout]
        c = 0.5 * torch.randn(c_shape, generator=gen, device=dev)
        for variant in ob.BSPLINE_VARIANTS:
            def fn():
                return ob.bspline_inverse(y, c, layout, variant=variant)
            with torch.inference_mode():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                kernel = {}
                try:
                    for k in (1, 4):
                        torch.cuda._sleep = lambda n, k=k: sleep(n * k)
                        kernel[k] = sorted(cs.time_ms(fn, 50, True)
                                           for _ in range(4))
                finally:
                    torch.cuda._sleep = sleep
            print(f"host {layout} {shape} {variant}: {host_us:.1f} us a "
                  f"call on the host; kernel us per launch, sleep-ahead 1x "
                  + " / ".join(f"{1e3 * v:.2f}" for v in kernel[1])
                  + ", 4x " + " / ".join(f"{1e3 * v:.2f}" for v in kernel[4])
                  + f" {tag}", flush=True)


def sample(a, b):
    code = ("import os, sys, subprocess, torch; root = sys.argv[1]; "
            "sys.path.insert(0, root); os.chdir(root); "
            "import chip_smoke as cs; "
            "from inverse_flow_tpu_torch.ops import _build; "
            "_build.chain_solve_lib(0); _build.bspline_inverse_lib(); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            "smi = subprocess.run(['nvidia-smi', '--query-gpu=name,"
            "power.limit', '--format=csv,noheader'], capture_output=True, "
            "text=True).stdout.strip(); "
            "cs.phase_bspline_glow(torch.device('cuda', 0), f'[{smi}]', "
            "torch)")
    for root in (a, b, b, a):
        root = os.path.abspath(root)
        done = subprocess.run([sys.executable, "-c", code, root],
                              capture_output=True, text=True)
        lines = [ln for ln in done.stdout.splitlines()
                 if "Flow.sample of" in ln]
        print(f"sample from {os.path.relpath(root, HERE) or '.'}: "
              f"{lines[0] if lines else done.stderr[-2000:]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("bspline_probe.py needs a CUDA card")
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["ablation"]:
        ablation(torch)
    elif sys.argv[1:2] == ["host"]:
        host(torch)
    elif sys.argv[1:2] == ["sample"] and len(sys.argv) == 4:
        sample(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
