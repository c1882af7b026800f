"""The (data, model) mesh of ranks and the coupling nets' tensor
parallelism.

Port of ``inverse_flow_tpu/parallel/mesh.py``: ``make_mesh``,
``make_mesh_2d`` and ``coupling_tp_shardings``. JAX lays a ``Mesh`` over
devices, places the parameters with ``device_put`` and lets XLA insert the
collectives. Here a :class:`Mesh` is a grid of ``torch.distributed`` ranks
with one process group for every row and every column, the parameters are
sliced in place (:func:`apply_shardings`), and the port places each
collective itself:

* in a coupling net, Megatron's pair: ``w1`` is column-parallel (split on
  its output channels) and ``w2`` row-parallel (split on its input
  channels); :func:`copy_to_model` before ``w1`` (identity forward, sum
  of the input's gradient over the model group backward) and
  :func:`reduce_from_model` after ``w2``'s conv (sum of the partial
  outputs forward, identity backward), so that every tensor after the net
  is the same on all ranks of a model group;
* after the backward, :func:`all_reduce_grads_`: every gradient averaged
  over the data axis, as ``jax.lax.pmean`` over ``data``, and each
  replicated one over the model axis too, which keeps the replicas
  bitwise equal (:func:`mesh_replicas_equal` checks them);
* in the optimizer's global-norm clip, :func:`clip_grad_norm_`: a shard's
  sum of squares is summed over the model group, a replicated
  parameter's counted once.

A rank at mesh coordinates (d, m) trains rows ``[d*B/D, (d+1)*B/D)`` of
the global batch (``shard_batch`` by the data index) and draws its noise
from a generator seeded by ``rank_seed(seed, d)``: the ranks of a model
group must see the same inputs and the same dequantization noise, or the
all-reduce adds up nets run on different inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .data_parallel import all_reduce_mean_, replicas_equal, world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: ``shape`` maps each of ``axis_names`` to its size,
    ``coords`` this rank's index on each axis (None for a rank outside the
    grid), ``groups`` the process group along each axis, the ranks that
    share every other coordinate (None without a process group)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Optional[Dict[str, int]] = None
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def data_group(self):
        """The ranks with this rank's model index (its column)."""
        return self.groups.get("data")

    @property
    def model_group(self):
        """The ranks with this rank's data index (its row)."""
        return self.groups.get("model")

    def index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError("this rank lies outside the mesh")
        return self.coords[axis]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """The 1-D mesh: the world's first ``n_devices`` ranks (all of them
    by default) on ``axis``. Raises rather than build a smaller mesh than
    asked for."""
    rank, size = world()
    n = size if n_devices is None else n_devices
    if n > size:
        raise ValueError(
            f"make_mesh: requested {n} ranks but only {size} are available "
            f"— a silently smaller mesh would change the DP degree behind "
            f"the caller's back")
    group = None
    if dist.is_initialized():
        # new_group is collective over the world: every rank makes it
        group = dist.group.WORLD if n == size else \
            dist.new_group(list(range(n)))
    inside = rank < n
    return Mesh((axis,), {axis: n}, {axis: rank} if inside else None,
                {axis: group} if inside else {})


def make_mesh_2d(n_data: int, n_model: int,
                 axes=("data", "model")) -> Mesh:
    """The 2-D mesh of the world's first ``n_data * n_model`` ranks in
    row-major order, as ``devices.reshape(n_data, n_model)``: rank r at
    ``(r // n_model, r % n_model)``. Every rank, one outside the grid
    too, makes every row's and every column's group in the same order
    (``dist.new_group`` is collective over the world). Without a process
    group only a 1 x 1 mesh exists."""
    rank, size = world()
    need = n_data * n_model
    if need > size:
        raise ValueError(
            f"make_mesh_2d: requested {n_data}x{n_model}={need} ranks but "
            f"only {size} are available")
    data_axis, model_axis = axes
    shape = {data_axis: n_data, model_axis: n_model}
    grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    rows, cols = [None] * n_data, [None] * n_model
    if dist.is_initialized():
        rows = [dist.new_group(row) for row in grid]
        cols = [dist.new_group([row[m] for row in grid])
                for m in range(n_model)]
    if rank >= need:
        return Mesh(tuple(axes), shape)
    d, m = divmod(rank, n_model)
    return Mesh(tuple(axes), shape, {data_axis: d, model_axis: m},
                {data_axis: cols[m], model_axis: rows[d]})


# ---------------------------------------------------------------------------
# the coupling nets' shardings
# ---------------------------------------------------------------------------

def coupling_tp_shardings(flow, mesh: Mesh, axis: str = "model"):
    """For each of ``flow``'s parameter names, the dimension sharded over
    ``axis``, or None (replicated): JAX's rule, read from the leaf name.
    ``w1`` (.., width, cin, kh, kw) shards its width, dimension ndim - 4;
    ``w2`` (.., cout, width, 1, 1) its width, ndim - 3; so a
    ``RepeatedBlock``'s stacked (K, ...) weights shard dimension 1 or 2.
    Every other parameter, a weight whose width the axis size does not
    divide, and every parameter of a mesh without ``axis`` is None."""
    names = [name for name, _ in flow.named_parameters()]
    if axis not in mesh.axis_names:
        return dict.fromkeys(names)
    n = mesh.shape[axis]
    specs = {}
    for name, p in flow.named_parameters():
        leaf = name.rpartition(".")[2]
        dim = None
        if leaf == "w1" and p.ndim >= 4:
            dim = p.ndim - 4
        elif leaf == "w2" and p.ndim >= 4:
            dim = p.ndim - 3
        specs[name] = None if dim is None or p.shape[dim] % n else dim
    return specs


def is_sharded(p) -> bool:
    """Whether :func:`apply_shardings` made ``p`` a shard."""
    return getattr(p, "sharded_dim", None) is not None


def _sharded(specs, mesh, axis):
    """The (name, dim) of ``specs`` that are sharded over an ``axis`` of
    more than one rank."""
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return []
    return [(name, dim) for name, dim in specs.items() if dim is not None]


@torch.no_grad()
def apply_shardings(flow, specs, mesh: Mesh, axis: str = "model"):
    """``tree_map(jax.device_put, params, shardings)``: every parameter
    that ``specs`` shards is replaced by this rank's contiguous slice
    (model index m of n takes ``[m*w/n, (m+1)*w/n)`` along its dimension;
    ``requires_grad`` kept; the dimension in its ``sharded_dim``), and
    each layer that owns one is given the model group, through which its
    net sums. Nothing changes on an axis of one rank. Returns ``flow``."""
    sharded = _sharded(specs, mesh, axis)
    if not sharded:
        return flow
    n, m = mesh.shape[axis], mesh.index(axis)
    group = mesh.groups.get(axis)
    for name, dim in sharded:
        owner_name, _, leaf = name.rpartition(".")
        owner = flow.get_submodule(owner_name)
        if not hasattr(owner, "model_group"):
            raise TypeError(f"{name}: {type(owner).__name__} has no "
                            f"tensor-parallel net")
        full = owner.get_parameter(leaf)
        w = full.shape[dim] // n
        shard = torch.nn.Parameter(
            full.narrow(dim, m * w, w).clone(),
            requires_grad=full.requires_grad)
        shard.sharded_dim = dim
        setattr(owner, leaf, shard)
        owner.model_group = group
    return flow


def gather_shard(t, dim: int, group):
    """The whole tensor of which ``t`` is this rank's slice along ``dim``:
    the slices of the ranks of ``group`` concatenated in rank order (gloo
    gathers on the host)."""
    n = dist.get_world_size(group)
    on = t.device if dist.get_backend(group) == "nccl" else \
        torch.device("cpu")
    src = t.detach().to(on).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


@torch.no_grad()
def gather_shardings(flow, specs, mesh: Mesh, axis: str = "model"):
    """The state dict of the unsharded flow: every shard all-gathered over
    the model group, the rest as it is (for a checkpoint, the bridge,
    tests). Every rank of the model group must call it."""
    state = dict(flow.state_dict())
    for name, dim in _sharded(specs, mesh, axis):
        state[name] = gather_shard(state[name], dim, mesh.groups.get(axis))
    return state


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _all_reduce_sum(t, group):
    """``t`` summed over ``group``, in float32 (a bf16 sum would round a
    second time where the unsharded conv rounds once), cast back."""
    out = t.to(torch.float32, copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    """The input of a column-parallel conv: the identity forward; its
    gradient, which each rank has only from its own slice of the width,
    summed over ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The output of a row-parallel conv: each rank's partial sum over its
    slice of the width, summed over ``group`` forward (in float32); the
    identity backward."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_grads_(params, mesh: Mesh, extra=()):
    """The gradient collectives of a step under ``mesh``: every
    gradient (a missing one as zeros) and every tensor of ``extra`` (the
    loss) averaged over the data group; then each replicated parameter's
    gradient averaged over the model group too. Those are equal on the
    ranks of a model group up to the order in which cuDNN's weight
    gradients and the scatters' backward sum, which the card does not fix;
    averaging makes them bitwise equal, so the replicas stay equal."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in params] + list(extra),
                     group=mesh.data_group)
    if mesh.shape.get("model", 1) > 1:
        all_reduce_mean_([p.grad for p in params if not is_sharded(p)],
                         group=mesh.model_group)


def mesh_replicas_equal(params, mesh: Mesh, optimizer=None) -> bool:
    """Whether the replicated ``params`` (and their state in
    ``optimizer``) are bitwise equal on every rank, and each shard (and
    its state) on every rank of its data group."""
    def with_state(ps):
        if optimizer is None:
            return ps
        return ps + [t for p in ps for t in optimizer.state[p].values()
                     if torch.is_tensor(t)]
    shards = [p for p in params if is_sharded(p)]
    return replicas_equal(with_state(
        [p for p in params if not is_sharded(p)])) and (
        not shards or replicas_equal(with_state(shards),
                                     group=mesh.data_group))


@torch.no_grad()
def clip_grad_norm_(params, max_norm: float, group):
    """``torch.nn.utils.clip_grad_norm_`` on the global norm of the
    unsharded gradients: each shard's sum of squares summed over the model
    ``group``, each replicated gradient counted once; every gradient
    scaled by ``min(1, max_norm / (norm + 1e-6))``. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    shard_sq = torch.zeros((), device=grads[0].device)
    replica_sq = torch.zeros((), device=grads[0].device)
    for p in params:
        if p.grad is None:
            continue
        sq = p.grad.detach().float().pow(2).sum()
        if is_sharded(p):
            shard_sq = shard_sq + sq
        else:
            replica_sq = replica_sq + sq
    dist.all_reduce(shard_sq, group=group)
    norm = (shard_sq + replica_sq).sqrt()
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return norm
