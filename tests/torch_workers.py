"""Functions that the port's multi-process tests run in processes of
their own: the ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_mesh.py``, started by
``inverse_flow_tpu_torch.parallel.spawn`` inside a gloo group on the CPU,
which build their flows and loaders from the numpy arrays they are given
and return numpy arrays and numbers; and the concurrent native build of
``tests/test_torch_native.py``. This module imports no JAX, so that a
process starts in a few seconds.
"""

import copy
from unittest import mock

import torch
import torch.distributed as dist

from inverse_flow_tpu_torch import native
from inverse_flow_tpu_torch import parallel as dp
from inverse_flow_tpu_torch.data import synthetic
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.distributions import GaussianPrior
from inverse_flow_tpu_torch.layers import (ActNorm, BSplineCoupling,
                                           Coupling, Flow, InvFlowUnit,
                                           RepeatedBlock, SelfNormConv)
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.train import experiment as texperiment
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.train.optim import apply_grads, make_optimizer

SIZE = (2, 8, 8)
TINY = (1, 8, 8)


def _one_thread():
    """A rank runs on one CPU thread: the test's ranks share the host with
    the other test workers."""
    torch.set_num_threads(1)


def det_fused_flow():
    """``tests/test_experiment.py:_det_fused_setup``'s flow: no noise."""
    g = torch.Generator().manual_seed(0)
    return Flow(GaussianPrior(SIZE),
                [ActNorm(2, generator=g),
                 InvFlowUnit(2, (3, 3), solver="fused", generator=g),
                 Coupling(SIZE, width=8, generator=g)])


def selfnorm_flow():
    """``test_shard_map_dp_selfnorm_recon_geco_parity``'s flow."""
    g = torch.Generator().manual_seed(0)
    return Flow(GaussianPrior(SIZE),
                [SelfNormConv(2, 2, (3, 3), bias=True, padding=1,
                              generator=g)])


def tiny_glow():
    """``tests/test_experiment.py:_tiny_setup``'s Glow: dequantization
    noise, ActNorm, two ``InvFlowNoPad`` steps, SLR."""
    return build_glow(TINY, step_kind="inv_conv_no_pad", num_blocks=1,
                      block_size=2, coupling_width=16, actnorm=True,
                      split_prior=False, activation="SLR", device="cpu",
                      generator=torch.Generator().manual_seed(0))


FLOWS = {"det_fused": det_fused_flow, "selfnorm": selfnorm_flow,
         "tiny_glow": tiny_glow}


def config(tmp, **kw):
    """The JAX DP tests' config: lr 1e-3, warmup 1 epoch, no images."""
    base = dict(name="dp", epochs=1, lr=1e-3, batch_size=16,
                warmup_epochs=1, log_interval=100, sample_epochs=1000,
                n_samples=2, add_recon_grad=False, plot_recon=False,
                save_images=False, log_timing=False,
                checkpoint_path=f"{tmp}/ckpt.pt",
                metrics_path=f"{tmp}/m.jsonl")
    return ExperimentConfig(**dict(base, **kw))


def experiment(flow_name, state, data, cfg, shuffle=False):
    """An Experiment on the CPU over ``FLOWS[flow_name]`` with the weights
    ``state`` (numpy, by name; the flow's own init when None), on loaders
    of batch ``cfg.batch_size`` over ``data["train"]``, ``["val"]`` and
    ``["test"]``."""
    flow = FLOWS[flow_name]()
    if state is not None:
        flow.load_state_dict({k: torch.from_numpy(v) for k, v in
                              state.items()})
    b = cfg.batch_size
    loaders = (ArrayLoader(data["train"], b, shuffle=shuffle, seed=cfg.seed),
               ArrayLoader(data["val"], b, drop_last=False),
               ArrayLoader(data["test"], b, drop_last=False))
    return Experiment(flow, *loaders, cfg, device="cpu")


def numpy_state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# rank functions: fn(rank, world_size, *args)
# ---------------------------------------------------------------------------

def eval_and_step(rank, size, flow_name, state, data, cfg, x):
    """Data init on the global batch ``x``, eval over the val split, one
    train step on this rank's slice of ``x``."""
    _one_thread()
    exp = experiment(flow_name, state, data, cfg)
    exp.maybe_data_init(x)
    logpx = exp.eval_epoch(exp.val_loader)
    loss = float(exp.train_step(torch.from_numpy(exp.shard(x))))
    return dict(logpx=logpx, loss=loss, params=numpy_state(exp.flow),
                equal=exp.replicas_equal())


def geco_steps(rank, size, flow_name, state, data, cfg, x, steps):
    """``steps`` train steps on this rank's slice of ``x``, with the recon
    term and GECO; the loss, recon loss and GECO weight of the last."""
    _one_thread()
    exp = experiment(flow_name, state, data, cfg)
    exp._data_initialized = True
    equal = []
    for _ in range(steps):
        loss = float(exp.train_step(torch.from_numpy(exp.shard(x))))
        equal.append(exp.replicas_equal())
    return dict(loss=loss, recon=float(exp.last_recon),
                recon_weight=float(exp.recon_weight),
                params=numpy_state(exp.flow), equal=equal)


def noise_step(rank, size, flow_name, data, cfg, x):
    """Data init, then one train step on this rank's slice; the weights
    after data init, this rank's generator state before the step, the
    averaged loss and the averaged gradients as the optimizer got them."""
    _one_thread()
    exp = experiment(flow_name, None, data, cfg)
    exp.maybe_data_init(x)
    state = numpy_state(exp.flow)
    gen_state = exp.generator.get_state().numpy().copy()
    loss, grads = recorded_step(exp, torch.from_numpy(exp.shard(x)))
    return dict(state=state, gen_state=gen_state, loss=loss, grads=grads)


def recorded_step(exp, xb):
    """``exp.train_step(xb)``: the loss, and the gradients that
    ``apply_grads`` received."""
    seen = {}
    apply = texperiment.apply_grads

    def recorded(cfg, optimizer, scheduler, params):
        seen["grads"] = [p.grad.numpy().copy() for p in params]
        return apply(cfg, optimizer, scheduler, params)

    with mock.patch.object(texperiment, "apply_grads", recorded):
        loss = float(exp.train_step(xb))
    return loss, seen["grads"]


def train_epochs(rank, size, epochs, cfg):
    """The tiny Glow on synthetic data (as ``_tiny_setup``) for ``epochs``
    epochs, ``replicas_equal`` after every step; the mean losses and the
    val log p(x)."""
    _one_thread()
    flow = tiny_glow()
    loaders = synthetic.load_data(TINY, n_train=64, n_val=32, n_test=32,
                                  batch_size=cfg.batch_size)
    exp = Experiment(flow, *loaders, cfg, device="cpu")
    equal, step = [], exp.train_step

    def checked(xb):
        loss = step(xb)
        equal.append(exp.replicas_equal())
        return loss

    exp.train_step = checked
    losses = [exp.train_epoch(e) for e in range(1, epochs + 1)]
    return dict(losses=losses, equal=equal,
                logpx=exp.eval_epoch(exp.val_loader))


def one_rank_matches_one_device(rank, size, data, cfg, steps):
    """At a world of one: the data-parallel Experiment against one without
    data parallelism, on the same weights and batches, over ``steps``
    steps: whether every loss and every parameter is bitwise equal."""
    _one_thread()
    flow = tiny_glow()
    exps = []
    for data_parallel in (True, False):
        exp = Experiment(copy.deepcopy(flow),
                         *(ArrayLoader(data["train"], cfg.batch_size)
                           for _ in range(3)),
                         cfg.replace(data_parallel=data_parallel),
                         device="cpu")
        exps.append(exp)
    assert exps[0].distributed and not exps[1].distributed
    same = []
    for i in range(steps):
        x = data["train"][i * cfg.batch_size:(i + 1) * cfg.batch_size]
        losses = []
        for exp in exps:
            exp.maybe_data_init(x)
            losses.append(exp.train_step(torch.from_numpy(exp.shard(x))))
        same.append(torch.equal(*losses) and all(
            torch.equal(a, b) for a, b in zip(exps[0].flow.parameters(),
                                              exps[1].flow.parameters())))
    return same


def indivisible_batch(rank, size, data, cfg):
    """The error of an Experiment whose train batch the world does not
    divide."""
    _one_thread()
    try:
        experiment("tiny_glow", None, data, cfg)
    except ValueError as e:
        return str(e)
    return None


def run_and_resume(rank, size, data, cfg):
    """``run()`` for ``cfg.epochs`` epochs, then a fresh Experiment that
    ``load``s the checkpoint: whether it holds the trained state, and
    whether the replicas are equal before and after."""
    _one_thread()
    exp = experiment("tiny_glow", None, data, cfg, shuffle=True)
    summary = exp.run()
    trained = exp.replicas_equal()
    resumed = experiment("tiny_glow", None, data, cfg, shuffle=True)
    resumed.load()
    same = all(torch.equal(a, b) for a, b in zip(
        exp.flow.state_dict().values(), resumed.flow.state_dict().values()))
    same = same and all(
        torch.equal(a, b) for s, r in zip(exp.optimizer.state.values(),
                                          resumed.optimizer.state.values())
        for a, b in zip(s.values(), r.values()))
    return dict(summary=summary, trained_equal=trained, resumed_same=same,
                resumed_equal=resumed.replicas_equal(),
                step=resumed.step)


def native_library(build_dir):
    """Whether the native library loads from ``build_dir`` (building it
    there if no other process has), and the path it loaded."""
    return native.available(build_dir), native.build(build_dir)


def cli_under_torchrun(rank, size, name, workdir):
    """``cli.main([--name name --smoke --cpu])`` as ``torchrun`` would start
    it on this rank (its environment; the group already joined), in
    ``workdir``; what it printed and returned, and the world it saw."""
    import contextlib
    import io
    import os

    from inverse_flow_tpu_torch import cli, parallel

    _one_thread()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank))
    os.chdir(workdir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--name", name, "--smoke", "--cpu"])
    return dict(rc=rc, out=out.getvalue(), world=tuple(parallel.world()))


# ---------------------------------------------------------------------------
# the (data, model) mesh: tests/test_torch_mesh.py
# ---------------------------------------------------------------------------

SPLINE_SIZE = (4, 4, 4)


def tp_glow(width=16, remat=True, dtype="float32"):
    """``test_coupling_tp_sharding_matches_replicated``'s Glow: L=1 x K=2
    ``InvFlowNoPad`` steps, SLR, each coupling net checkpointed
    (``remat``) unless asked, in ``dtype``."""
    return build_glow(TINY, step_kind="inv_conv_no_pad", num_blocks=1,
                      block_size=2, coupling_width=width, actnorm=True,
                      split_prior=True, activation="SLR",
                      coupling_remat=remat, coupling_dtype=dtype,
                      device="cpu", generator=torch.Generator().manual_seed(0))


def tp_bspline():
    """ActNorm and a ``BSplineCoupling`` of width 16 on (4, 4, 4)."""
    g = torch.Generator().manual_seed(0)
    return Flow(GaussianPrior(SPLINE_SIZE),
                [ActNorm(4, generator=g),
                 BSplineCoupling(SPLINE_SIZE, width=16, generator=g)])


def tp_bspline_block():
    """A ``RepeatedBlock`` of 3 (ActNorm, ``BSplineCoupling``) steps, the
    weights stacked on a leading K."""
    g = torch.Generator().manual_seed(0)
    return Flow(GaussianPrior(SPLINE_SIZE), [RepeatedBlock(
        lambda: [ActNorm(4, generator=g),
                 BSplineCoupling(SPLINE_SIZE, width=16, generator=g)], 3)])


MESH_FLOWS = {"glow": tp_glow,
              "glow_no_remat": lambda: tp_glow(remat=False),
              "glow_bf16": lambda: tp_glow(dtype="bfloat16"),
              "glow_width6": lambda: tp_glow(width=6),
              "bspline": tp_bspline, "bspline_block": tp_bspline_block}


def mesh_flow(name, state):
    """``MESH_FLOWS[name]`` with the weights ``state`` (numpy, by name)."""
    flow = MESH_FLOWS[name]()
    flow.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return flow


def body(flow):
    """The layers after a Glow's dequantization (its noise comes in with
    the input), or the flow itself."""
    if type(flow.layers[0]).__name__ == "Dequantization":
        return Flow(flow.base_distribution, flow.layers[1:])
    return flow


def mesh_grads(flow, mesh, x, generator=None):
    """A step's forward, backward and gradient collectives on this data
    row's slice of the global batch ``x``: the loss, averaged over the
    data axis."""
    params = [p for p in flow.parameters() if p.requires_grad]
    for p in params:
        p.grad = None
    xb = dp.shard_batch(x, mesh.index("data"), mesh.shape["data"])
    loss = -flow(xb, generator)[1].mean()
    loss.backward()
    loss = loss.detach().reshape(1)
    dp.all_reduce_grads_(params, mesh, extra=[loss])
    return float(loss)


def gathered(flow, mesh, what):
    """``what(p)`` of every parameter, by name, each shard all-gathered
    over the model group, as numpy."""
    out = {}
    for name, p in flow.named_parameters():
        t = what(p)
        if dp.is_sharded(p):
            t = dp.gather_shard(t, p.sharded_dim, mesh.model_group)
        out[name] = t.detach().numpy().copy()
    return out


def mesh_cases(rank, size, shape, cases, cfg, noise_case):
    """:func:`mesh_guards`; then at a (data, model) mesh of ``shape``:
    where this rank sits and its groups; for each (name, state, x, z) of
    ``cases``, ``mesh_flow(name, state)`` sharded by
    ``coupling_tp_shardings``, then on its body (:func:`body`, x the input
    after dequantization): ``Flow.sample`` of the base draws ``z`` and a
    ``reconstruct`` of x, one step (the loss,
    the gathered gradients, their global norm, the gathered weights after
    ``apply_grads`` of ``cfg``, whether the replicas are equal); and for
    ``noise_case`` (name, state, x, seed) the whole flow's data init on x
    with the shared seed, then a step's loss with each data row's own
    noise (``rank_seed(seed, data index)``)."""
    _one_thread()
    guards = mesh_guards(rank, size)
    mesh = dp.make_mesh_2d(*shape)
    out = dict(guards=guards, coords=mesh.coords,
               data_ranks=dist.get_process_group_ranks(mesh.data_group),
               model_ranks=dist.get_process_group_ranks(mesh.model_group))
    for name, state, x, z in cases:
        flow = mesh_flow(name, state)
        specs = dp.coupling_tp_shardings(flow, mesh)
        dp.apply_shardings(flow, specs, mesh)
        net = body(flow)
        x = torch.from_numpy(x)
        r = dict(sample=net.sample(len(z), noise={"base": torch.from_numpy(
            z)}).numpy(),
            recon=net.reconstruct(x, torch.Generator().manual_seed(0))
            .numpy())
        params = [p for p in flow.parameters() if p.requires_grad]
        optimizer, scheduler = make_optimizer(cfg, params, 1)
        r["loss"] = mesh_grads(net, mesh, x)
        r["grads"] = gathered(flow, mesh, lambda p: p.grad)
        r["norm"] = float(dp.clip_grad_norm_(params, float("inf"),
                                             mesh.model_group))
        apply_grads(cfg, optimizer, scheduler, params,
                    model_group=mesh.model_group)
        r["equal"] = dp.mesh_replicas_equal(list(flow.parameters()), mesh,
                                            optimizer)
        r["params"] = {k: v.numpy().copy() for k, v in
                       dp.gather_shardings(flow, specs, mesh).items()}
        r["shards"] = sorted(n for n, p in flow.named_parameters()
                             if dp.is_sharded(p))
        out[name] = r
    if noise_case is not None:
        name, state, x, seed = noise_case
        flow = mesh_flow(name, state)
        x = torch.from_numpy(x)
        flow.data_init(x, torch.Generator().manual_seed(seed))
        dp.apply_shardings(flow, dp.coupling_tp_shardings(flow, mesh), mesh)
        gen = torch.Generator().manual_seed(
            dp.rank_seed(seed, mesh.index("data")))
        out["noise_loss"] = mesh_grads(flow, mesh, x, gen)
    return out


def mesh_guards(rank, size):
    """``make_mesh`` and ``make_mesh_2d`` in this world: the messages of
    the requests it cannot hold, and where a mesh of the whole world and a
    (1, 2) mesh put this rank."""
    errors = []
    for make, args in ((dp.make_mesh, (size + 1,)),
                       (dp.make_mesh_2d, (size, 2))):
        try:
            make(*args)
        except ValueError as e:
            errors.append(str(e))
    one = dp.make_mesh()
    row = dp.make_mesh_2d(1, 2)
    return dict(errors=errors, one=(one.size, one.coords),
                row=(row.size, row.coords,
                     None if row.coords is None else
                     dist.get_process_group_ranks(row.model_group)))
