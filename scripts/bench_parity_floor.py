#!/usr/bin/env python3
"""The readings under two of ``chip_smoke.py`` phase 19's parity bounds,
on the card.

    python3 scripts/bench_parity_floor.py

Needs a CUDA card and ``nvcc``. Float32 with TF32 off, as
``chip_smoke.py`` runs; each model is ``bench.py``'s configuration at full
width and depth with the bench's data init (``chip_smoke.bench_model``).

- ``glow_mnist_bf16_couplings`` (``BF16_GRAD_PARITY``): for four
  dequantization noise draws (seeds 0-3), ``chip_smoke.check_grads`` of
  the step through the kernel against the plain chain, and against the
  same step through the kernel (run to run); each with cuDNN's default
  algorithms and under deterministic ones.
- ``imagenet32_exact`` against ``imagenet32`` on the same weights
  (``BENCH_EXACT_RTOL``), and ``imagenet32_exact`` against itself; each
  both ways.

No bound is applied (tol inf): each line prints its loss and gradient
readings by relative norm, after a line with the card's name and power
limit.
"""

from __future__ import annotations

import contextlib
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_parity_floor.py needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from inverse_flow_tpu_torch.experiments import bench_configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    def readings(label, flow, x, seeds, references):
        for det in (False, True):
            with cs.deterministic(torch) if det else \
                    contextlib.nullcontext():
                for seed in seeds:
                    for what, ref in references:
                        gen = torch.Generator(dev).manual_seed(seed)
                        cs.check_grads(
                            f"floor: {label} {what}, noise seed {seed}, "
                            f"{'deterministic' if det else 'default'} "
                            f"algorithms", flow, x, gen, dev, torch,
                            math.inf, ref)

    flow, x, _ = cs.bench_model("glow_mnist_bf16_couplings", dev, torch)
    readings("glow_mnist_bf16_couplings", flow, x, range(4),
             (("vs plain chain", None), ("run to run", flow)))
    del flow
    torch.cuda.empty_cache()

    flow, x, _ = cs.bench_model("imagenet32_exact", dev, torch)
    unit = bench_configs.build("imagenet32", dev,
                               torch.Generator(dev).manual_seed(1))[0]
    unit.load_state_dict(flow.state_dict())
    readings("imagenet32_exact", flow, x, (0,),
             (("vs imagenet32", unit), ("run to run", flow)))


if __name__ == "__main__":
    main()
