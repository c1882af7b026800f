"""Training: ``Experiment.train_step`` in a closed loop.

Set-up builds one ``Experiment`` (the flow on the benchmark's weights,
Adam with the configuration's schedule and clamp), runs ActNorm's data
init on the first batch, and drives the first ``checked_steps`` steps
through ``train_step``, cycling over the pool of ``pool_batches`` batches
(every row a different image, every step fresh dequantization noise).
The pool is the epoch, the schedule's unit, so with two batches the
three checked steps cover the warmup's ramp, its end and the first
epoch's decay. Those steps warm up every shape the window uses, and their
losses, the first step's gradient (Adam's first moment after one step
over 1 - beta1) and the parameters' change over them are what the check
compares. The window then goes on with the same object over the same
pool, each step's loss read back as a user's loop logs it. A unit is a
step; it carries ``batch`` images.
"""

from __future__ import annotations

import gc
import math


def setup(cell):
    import torch

    from benchmark import compare, inputs, program
    from benchmark.reference import glow as ref

    tr, dev = cell.traffic, cell.device
    shape = tuple(cell.config["data_shape"])
    weights = ref.make_weights(cell.config["model"], shape,
                               inputs.generator(cell.seed, "weights", dev),
                               dev)
    flow = program.build_flow(cell, weights)
    del weights
    igen = inputs.generator(cell.seed, "images", dev)
    pool = [inputs.smooth_images(tr["batch"], shape, igen, dev)
            for _ in range(tr["pool_batches"])]
    noise_seed = inputs.sub_seed(cell.seed, "noise")
    exp = program.experiment(cell, flow, noise_seed)
    exp.maybe_data_init(pool[0].cpu().numpy())
    params = {n: p for n, p in flow.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, grad_norms = [], None
    for k in range(tr["checked_steps"]):
        losses.append(float(exp.train_step(pool[k % len(pool)])))
        if k == 0:
            beta1 = exp.optimizer.param_groups[0]["betas"][0]
            grad_norms = compare.leaf_norms(
                {n: exp.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - beta1)
                 for n, p in params.items()})
    change = compare.leaf_norms({n: p.detach() - start[n]
                                 for n, p in params.items()})
    del start
    if dev != "cpu":
        torch.cuda.synchronize()
    return {"exp": exp, "pool": pool, "noise_seed": noise_seed,
            "losses": losses, "grad_norms": grad_norms, "change": change,
            "bad": 0}


def unit(state, k):
    pool = state["pool"]
    loss = float(state["exp"].train_step(
        pool[(k + len(state["losses"])) % len(pool)]))
    if not math.isfinite(loss):
        state["bad"] += 1
    return pool[0].shape[0]


def failed(state):
    return state["bad"]


def reference_readings(cell, pool, noise_seed, control=False, keep=None):
    """The plain reference's losses, first-step gradient norms, change
    norms and loud leaves over the checked steps, from the seed's weights
    and the same batches and dequantization noise (``control``: in the
    precision below the configuration's; ``keep``: each step on its
    batch's first ``keep`` rows alone, the fault of a step that leaves
    the rest out)."""
    import torch

    from benchmark import compare, inputs, program
    from benchmark.reference import glow as ref

    tr, dev = cell.traffic, cell.device
    shape = tuple(cell.config["data_shape"])
    weights = ref.make_weights(cell.config["model"], shape,
                               inputs.generator(cell.seed, "weights", dev),
                               dev)
    model = ref.Reference(cell.config, weights, control=control)
    noise = torch.Generator(dev).manual_seed(noise_seed)
    b = tr["batch"]

    def draw():
        return torch.rand((b,) + shape, generator=noise, device=dev)

    model.data_init(pool[0], draw())
    start = {k: v.clone() for k, v in weights.items()}
    opt = cell.config["experiment"]
    spe = program.steps_per_epoch(cell)
    losses, norms = [], []
    for k in range(tr["checked_steps"]):
        loss, grads = model.loss_and_grads(pool[k % len(pool)][:keep],
                                           draw()[:keep],
                                           tr["reference_rows"])
        losses.append(loss)
        norms.append(compare.leaf_norms(grads))
        model.adam_step(grads, ref.lr_at(opt, spe, k),
                        clamp=opt.get("weight_clamp"))
        del grads
    change = compare.leaf_norms({k: weights[k] - start[k] for k in weights})
    return losses, norms[0], change, compare.loud_leaves(norms)


def compared(cell, prog, refr):
    """{number: {value, limit}} of the program's readings ``prog``
    (losses, first gradient, change) against the reference's ``refr``."""
    from benchmark import compare

    losses, grad, change = prog
    r_losses, r_grad, r_change, loud = refr
    lim = cell.limits
    return {
        "loss_gap": {"value": compare.loss_gap(losses, r_losses),
                     "limit": lim["loss_gap"]},
        "grad_gap": {"value": compare.worst_leaf_gap(grad, r_grad),
                     "limit": lim["grad_gap"]},
        "change_gap": {"value": compare.worst_leaf_gap(change, r_change,
                                                       loud),
                       "limit": lim["change_gap"]},
    }


def check(cell, state):
    import torch

    state.pop("exp", None)
    gc.collect()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    refr = reference_readings(cell, state["pool"], state["noise_seed"])
    return compared(cell, (state["losses"], state["grad_norms"],
                           state["change"]), refr)
