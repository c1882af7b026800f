"""Data parallelism: one process per card, a rank-sharded batch and one
gradient all-reduce a step.

Port of the semantics of ``inverse_flow_tpu/parallel/mesh.py`` and of the
JAX harness's default ``shard_map`` step
(``inverse_flow_tpu/train/experiment.py:216-235``): every rank reads the
same global batch and takes its contiguous slice (``P("data")``), draws
its own noise (``fold_in(rng, axis_index)``: here a generator seeded by
:func:`rank_seed`), and the gradients, the loss and the recon term are
averaged over the ranks before the replicated optimizer step
(``jax.lax.pmean``). The process group comes from ``torchrun``'s
environment (:func:`init_from_env`); without one the world is a single
rank, as JAX on one device builds no mesh. The 2-D (data, model) mesh and
the coupling nets' tensor-parallel shardings (``make_mesh_2d``,
``coupling_tp_shardings``) are :mod:`.mesh`'s.

The collectives here run on the default process group, or on the
``group`` they are given (a row or column of a :class:`~.mesh.Mesh`).
NCCL takes CUDA tensors only; gloo takes CPU tensors and, for all-reduce
and broadcast, CUDA tensors too (through the host). The checksum exchange
of :func:`replicas_equal` goes through the host under gloo.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from typing import Iterable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class World(NamedTuple):
    rank: int
    size: int


def init_from_env(cpu: bool = False) -> torch.device:
    """The device of this process, after joining the process group that
    ``torchrun`` describes in ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    (``init_method="env://"``): ``cuda:<LOCAL_RANK>`` over NCCL, or the
    CPU over gloo with ``cpu``. Without ``WORLD_SIZE`` in the environment
    no group is made and the device is the card (the CPU with ``cpu``)."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device("cpu" if cpu else "cuda")
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        device, backend = torch.device("cuda", local_rank), "nccl"
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def world() -> World:
    """This process's rank and the world size: (0, 1) without a group."""
    if not dist.is_initialized():
        return World(0, 1)
    return World(dist.get_rank(), dist.get_world_size())


def rank_seed(seed: int, rank: int) -> int:
    """The seed of ``rank``'s noise generator: ``seed`` itself on rank 0,
    so that one rank draws what a run without data parallelism draws; an
    independent stream derived from (seed, rank) on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def shard_batch(x, rank: int, size: int):
    """Rows ``[rank * B/size, (rank+1) * B/size)`` of the batch ``x``;
    raises unless ``size`` divides B."""
    b = x.shape[0]
    if b % size:
        raise ValueError(f"data parallelism: a batch of {b} does not split "
                         f"over a world of {size} ranks (B={b}, W={size})")
    per = b // size
    return x[rank * per:(rank + 1) * per]


def _flat_all_reduce_(tensors, mean: bool, group):
    tensors = list(tensors)
    if not tensors or not dist.is_initialized():
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(dist.get_world_size(group))
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return tensors


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None):
    """Each tensor replaced in place by its mean over the ranks of
    ``group`` (the default group when None), through one flat float32
    buffer and one all-reduce (``jax.lax.pmean``). Without a process
    group the tensors stay as they are."""
    return _flat_all_reduce_(tensors, True, group)


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group=None):
    """Each tensor replaced in place by its sum over the ranks of
    ``group`` (the default group when None), through one flat buffer and
    one all-reduce (``jax.lax.psum``)."""
    return _flat_all_reduce_(tensors, False, group)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0):
    """Each tensor replaced in place by rank ``src``'s value."""
    tensors = list(tensors)
    if dist.is_initialized():
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src)
    return tensors


def barrier():
    if dist.is_initialized():
        dist.barrier()


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 checksum of ``t``'s bits, position-weighted, so that any
    changed bit or swapped pair of elements changes it."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    bits = t.detach().contiguous().reshape(-1).view(view).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return (bits * weights).sum().reshape(1)


def replicas_equal(tensors: Iterable[torch.Tensor], group=None) -> bool:
    """Whether every rank of ``group`` (the default group when None)
    holds bitwise the same ``tensors`` (parameters, buffers, optimizer
    state, on any device): their checksums, all-gathered and compared.
    True without a process group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return True
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    sums = torch.cat([_checksum(t).to(device) for t in tensors])
    gathered = [torch.empty_like(sums)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, sums, group=group)
    return all(torch.equal(g, gathered[0]) for g in gathered[1:])


def _rank_entry(fn, rank, size, backend, init_method, results, args):
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size)
        try:
            results.put((rank, True, fn(rank, size, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, size: int, init_method: str, backend: str = "gloo",
          args=(), timeout: float = 120.0):
    """``fn(rank, size, *args)`` in ``size`` new processes (``spawn``
    start method), each in a process group of ``backend`` joined at
    ``init_method`` (a ``file://`` path that does not exist yet, or
    ``tcp://localhost:<port>``); returns the results by rank. A rank that
    raises fails the call with its traceback; past ``timeout`` seconds
    the call fails and every process still running is killed. ``fn`` and
    ``args`` must pickle: a function of an importable module."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, rank, size, backend, init_method,
                               results, tuple(args)))
             for rank in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, done = {}, False
    try:
        while len(out) < size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} of {size} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: {size - len(out)} of {size} ranks gave no "
                        f"result in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{value}")
            out[rank] = value
        done = True
    finally:
        for p in procs:
            # after a failure the other ranks may wait in a collective
            p.join(timeout=max(0.1, deadline - time.monotonic())
                   if done else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(size)]
