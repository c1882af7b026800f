"""Timescaling sweeps: train-step time against input size (the paper's
Fig. 4).

Port of ``inverse_flow_tpu/experiments/timescaling.py:run_timescaling``:
for each size, a 2-layer stack on synthetic tensors from seed 0, one loss
and backward per step, timed as 4 trials of ``iters`` chained steps after
one untimed trial; one JSONL record per size appended to
``./<name>_timescale.jsonl`` in the working directory. The name picks the
model: ``snf*`` SelfNorm 3x3 convs, ``*jacobi*`` ``InvFlowNoPad(1, (2, 2),
solver='jacobi')``, ``*auto*`` ``solver='auto'``, else the exact solve;
``*tall*`` the reference's literal (1, H, 1) inputs, else (1, s, s).

    python -m inverse_flow_tpu_torch.cli --name if_auto_tall_timescaling

runs on the CUDA card (``--cpu --smoke`` on the CPU at a tiny size).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def default_sizes(tall: bool, smoke: bool = False):
    """The JAX sweep's sizes: H = 32 ... 4160 tall, s = 8 ... 128
    square; two small ones for a smoke run."""
    if tall:
        return [32, 64] if smoke else [32, 128, 512, 2048, 4160]
    return [8, 16] if smoke else [8, 16, 32, 64, 128]


def timescale_model(name, shape, n_layers=2, device="cuda", generator=None):
    """The sweep's model for experiment ``name`` at input ``shape`` (C, H,
    W): ``n_layers`` step layers of the name's kind over a Gaussian
    prior."""
    from ..distributions import GaussianPrior
    from ..layers import Flow, InvFlowNoPad, SelfNormConv

    init = dict(generator=generator, device=device)
    if name.startswith("snf"):
        layers = [SelfNormConv(1, 1, (3, 3), bias=False, padding=1, **init)
                  for _ in range(n_layers)]
    else:
        solver = ("jacobi" if "jacobi" in name else
                  "auto" if "auto" in name else "exact")
        layers = [InvFlowNoPad(1, (2, 2), solver=solver, jacobi_iters=12,
                               **init)
                  for _ in range(n_layers)]
    return Flow(GaussianPrior(shape), layers)


def loss_and_grads(flow, x):
    """``-mean log p(x)`` (detached) and its gradients in the flow's
    parameters, the sweep's step."""
    params = list(flow.parameters())
    loss = -flow(x)[1].mean()
    return loss.detach(), torch.autograd.grad(loss, params)


def run_timescaling(name="if_timescaling", sizes=None, batch_size=128,
                    n_layers=2, iters=20, smoke=False, tall=False,
                    device="cuda"):
    """The sweep of experiment ``name``, as the JAX ``run_timescaling``:
    batch 128, 2 layers, 20 steps a trial (``smoke``: batch 16, 3 steps,
    two small sizes). Each step consumes ``x + 0.0 * loss`` of the step
    before, so the steps chain as in JAX. The trials are timed on the
    host clock from a ``torch.cuda.synchronize`` to another, so the
    card's queue cannot hide work. Returns 0."""
    tall = tall or ("tall" in name)
    if sizes is None:
        sizes = default_sizes(tall, smoke)
    if smoke:
        iters, batch_size = 3, 16
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out_path = f"./{name}_timescale.jsonl"
    for s in sizes:
        shape = (1, s, 1) if tall else (1, s, s)
        gen = torch.Generator(device).manual_seed(0)
        flow = timescale_model(name, shape, n_layers, device, gen)
        x = torch.as_tensor(np.random.RandomState(0).randn(
            batch_size, *shape).astype(np.float32), device=device)
        # one untimed trial: kernel builds, allocator and cuDNN warm-up
        loss, _ = loss_and_grads(flow, x)
        for _ in range(iters):
            loss, _ = loss_and_grads(flow, x + 0.0 * loss)
        sync()
        trials = []
        for _ in range(4):
            t0 = time.perf_counter()
            for _ in range(iters):
                loss, _ = loss_and_grads(flow, x + 0.0 * loss)
            sync()
            trials.append((time.perf_counter() - t0) / iters * 1e3)
        rec = {"size": s, "shape": list(shape), "batch": batch_size,
               "ms_mean": float(np.mean(trials)),
               "ms_std": float(np.std(trials)),
               "ms_best": float(min(trials))}
        print(json.dumps(rec), flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0
