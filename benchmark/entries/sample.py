"""Sampling: ``Flow.sample(batch, noise=...)`` in a closed loop.

Set-up builds the flow on the benchmark's weights, runs ActNorm's data
init on a batch of the seed's images, draws ``pool_batches`` sets of
latent noise (the prior's z and every SplitPrior's factored-out half)
from the seed, and makes one draw to warm up. In the window each draw is
handed the next noise set and synchronised; the last draw of each set is
kept. A unit is a draw of ``batch`` images. The check runs the plain
reference's inverse on the same weights, data init and noise, and
compares every image of every kept draw.
"""

from __future__ import annotations

import gc


def _noise(cell, dev):
    import torch

    from benchmark import inputs
    from benchmark.reference import glow as ref

    model, shape = cell.config["model"], tuple(cell.config["data_shape"])
    b = cell.traffic["batch"]
    gen = inputs.generator(cell.seed, "latents", dev)
    pool = []
    for _ in range(cell.traffic["pool_batches"]):
        noise = {"base": torch.randn((b,) + ref.final_shape(model, shape),
                                     generator=gen, device=dev)}
        for i, half in ref.split_shapes(model, shape).items():
            noise[i] = torch.randn((b,) + half, generator=gen, device=dev)
        pool.append(noise)
    return pool


def setup(cell):
    import torch

    from benchmark import inputs, program
    from benchmark.reference import glow as ref

    dev = cell.device
    shape = tuple(cell.config["data_shape"])
    weights = ref.make_weights(cell.config["model"], shape,
                               inputs.generator(cell.seed, "weights", dev),
                               dev)
    flow = program.build_flow(cell, weights)
    del weights
    images = inputs.smooth_images(cell.traffic["batch"], shape,
                                  inputs.generator(cell.seed, "images", dev),
                                  dev)
    noise_seed = inputs.sub_seed(cell.seed, "noise")
    flow.data_init(images, torch.Generator(dev).manual_seed(noise_seed))
    pool = _noise(cell, dev)
    draws = torch.Generator(dev).manual_seed(noise_seed)
    state = {"flow": flow, "pool": pool, "images": images,
             "noise_seed": noise_seed, "draws": draws,
             "kept": [None] * len(pool)}
    for k in range(cell.traffic["warmup_units"]):
        unit(state, k)
    state["kept"] = [None] * len(pool)
    return state


def unit(state, k):
    import torch

    i = k % len(state["pool"])
    x = state["flow"].sample(state["pool"][i]["base"].shape[0],
                             state["draws"], noise=state["pool"][i])
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    state["kept"][i] = x
    return x.shape[0]


def failed(state):
    import torch

    return sum(int(not bool(torch.isfinite(x).all()))
               for x in state["kept"] if x is not None)


def reference_images(cell, images, noise_seed, pool, control=False):
    """The plain reference's images from each noise set of ``pool``."""
    import torch

    from benchmark import inputs
    from benchmark.reference import glow as ref

    dev = cell.device
    shape = tuple(cell.config["data_shape"])
    weights = ref.make_weights(cell.config["model"], shape,
                               inputs.generator(cell.seed, "weights", dev),
                               dev)
    model = ref.Reference(cell.config, weights, control=control)
    noise = torch.Generator(dev).manual_seed(noise_seed)
    model.data_init(images, torch.rand(images.shape, generator=noise,
                                       device=dev))
    rows = cell.traffic["reference_rows"]
    out = []
    with torch.no_grad():
        for n in pool:
            b = n["base"].shape[0]
            out.append(torch.cat([
                model.inverse(n["base"][s:s + rows],
                              {i: t[s:s + rows] for i, t in n.items()
                               if i != "base"})
                for s in range(0, b, rows)]))
    return out


def compared(cell, kept, refs):
    from benchmark import compare

    # every noise set that the window drew (a short window may not reach
    # them all)
    worst = max([compare.worst_image_share(x, r)
                 for x, r in zip(kept, refs) if x is not None] or [1.0])
    return {"image_off_share": {"value": worst,
                                "limit": cell.limits["image_off_share"]}}


def check(cell, state):
    import torch

    state.pop("flow", None)
    gc.collect()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    refs = reference_images(cell, state["images"], state["noise_seed"],
                            state["pool"])
    return compared(cell, state["kept"], refs)
