"""Memory/speed benchmark: a Glow trained on random in-memory data.

Port of ``inverse_flow_tpu/experiments/memory_speed.py:run_memory_speed``:
``build_glow((3, 32, 32), step_kind, L=2, K=16, width 256, SLR)`` at batch
100 after data init, then ``torch.optim.Adam(lr=1e-5)`` over 20 chained
steps on the same batch; the record (ms per batch, the epoch of 50,000
images it implies, device memory from
:class:`~inverse_flow_tpu_torch.train.memory.MemoryTracker`) is printed
and appended to ``./memory_speed.jsonl`` in the working directory.

    python -m inverse_flow_tpu_torch.cli --name memory_speed [--smoke] [--cpu]
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def run_memory_speed(step_kind="inv_conv_no_pad", data_size=(3, 32, 32),
                     batch_size=100, num_blocks=2, block_size=16,
                     coupling_width=256, n_batches=20, smoke=False,
                     device="cuda"):
    """The JAX record's keys; ``compile_s`` is the first step's seconds
    (the kernels' build and the allocator's warm-up; nothing is compiled
    here otherwise). Returns 0."""
    from ..models.glow import build_glow
    from ..train.memory import MemoryTracker

    if smoke:
        data_size, batch_size = (1, 8, 8), 8
        num_blocks, block_size, coupling_width, n_batches = 1, 2, 16, 3
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    flow = build_glow(data_size, step_kind=step_kind, num_blocks=num_blocks,
                      block_size=block_size, coupling_width=coupling_width,
                      actnorm=True, split_prior=True, activation="SLR",
                      generator=gen, device=device)
    x = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (batch_size,) + tuple(data_size)).astype(np.float32),
        device=device)
    flow.data_init(x, gen)
    params = list(flow.parameters())
    opt = torch.optim.Adam(params, lr=1e-5)

    def train_step():
        opt.zero_grad(set_to_none=True)
        loss = -flow(x, gen)[1].mean()
        loss.backward()
        opt.step()
        return loss.detach()

    tracker = MemoryTracker(device)
    t0 = time.perf_counter()
    loss = train_step()
    sync()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n_batches):
        loss = train_step()
    sync()
    ms_per_batch = (time.perf_counter() - t0) / n_batches * 1e3

    mem = tracker.snapshot() if tracker.available else {}
    rec = {
        "step_kind": step_kind,
        "data_size": list(data_size),
        "batch_size": batch_size,
        "compile_s": round(compile_s, 2),
        "train_ms_per_batch": round(ms_per_batch, 3),
        "epoch_s_per_50k": round(ms_per_batch * (50_000 / batch_size) / 1e3,
                                 2),
        "loss": float(loss),
        **{f"memory_{k}": round(v, 1) for k, v in mem.items()},
    }
    print(json.dumps(rec), flush=True)
    with open("./memory_speed.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0
