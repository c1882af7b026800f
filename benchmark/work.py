"""The yardstick's arithmetic: the model's operations and bytes at a
cell's shapes, and the card's peaks.

Counted from the configuration's shapes alone, never from what the
program launches, so that a change to the program's implementation (its
block size, its densified operators, a recompute) cannot move the count.

* A coupling net (conv3x3 C/2 -> width, conv1x1 width -> C, conv3x3
  C -> C, 'same' padding) counts 2 FLOPs a multiply-add of each conv:
  once in a sampling pass, three times in a train step (forward, input
  gradient, weight gradient). Recompute under remat is not counted.
* A masked-conv solve counts 2 FLOPs for each off-diagonal nonzero tap
  that lands inside the image, for every output: once for the forward
  solve, once for the transposed solve and once for the weight gradient
  in a train step; the sampling direction applies the masked conv once.
* A solve's bytes (float32): its input read once, each order's output
  written once, each order's weights read once; in a train step the
  forward solve, the transposed solve (the cotangent in, each order's
  input cotangent out, the weights) and the weight gradient (written).
"""

from __future__ import annotations

from benchmark.reference.glow import levels

# NVIDIA's data sheet, H100 SXM at 700 W: dense float32 without tensor
# cores, dense bf16 on tensor cores, HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "bytes_per_s": 3.35e12},
}


def peaks(device_name):
    """The peaks of the card ``device_name``; None for a card not in the
    table (a metric that needs them then reads nothing)."""
    return PEAKS.get(device_name)


def net_macs(c, h, w, width):
    """Multiply-adds of one coupling net on one image at (C, H, W)."""
    return h * w * (width * (c // 2) * 9 + c * width + c * c * 9)


def masked_taps(c, h, w, kh=3, kw=3):
    """Off-diagonal nonzero taps of a masked kh x kw conv applied to one
    (C, H, W) image, counting only taps that land inside the image: every
    (c, c') pair at each non-centre tap, and the centre's strictly lower
    channel triangle."""
    taps = 0
    for i in range(kh):
        for j in range(kw):
            if i == kh - 1 and j == kw - 1:
                taps += c * (c - 1) // 2 * h * w
            else:
                taps += c * c * (h - (kh - 1 - i)) * (w - (kw - 1 - j))
    return taps


def n_orders(model):
    return 4 if model["step_kind"] == "inv_flow_unit" else 1


def model_work(config, batch, direction):
    """The math of one train step (``direction='train'``) or one sampling
    pass (``'sample'``) of ``batch`` images: a dict of FLOPs by precision
    (``float32``, ``bfloat16``), the solves' FLOPs and bytes, and each
    solve layer's (FLOPs, bytes) as ``solves``."""
    model = config["model"]
    net_dt = "bfloat16" if model["coupling_dtype"] in ("bfloat16", "bf16") \
        else "float32"
    passes = 3 if direction == "train" else 1
    orders = n_orders(model)
    flops = {"float32": 0, "bfloat16": 0}
    solves = []
    for (c, h, w), split in levels(model, config["data_shape"]):
        k = model["block_size"]
        nets = k + (1 if split else 0)
        flops[net_dt] += 2 * passes * nets * batch * net_macs(
            c, h, w, model["coupling_width"])
        f = 2 * passes * orders * batch * masked_taps(c, h, w)
        act = 4 * batch * c * h * w
        wts = 4 * orders * c * c * 9
        if direction == "train":
            by = 2 * act * (1 + orders) + 3 * wts
        else:
            by = act * (1 + orders) + wts
        solves += [(f, by)] * k
    solve_flops = sum(f for f, _ in solves)
    flops["float32"] += solve_flops
    return {"flops": flops, "solve_flops": solve_flops,
            "solve_bytes": sum(b for _, b in solves), "solves": solves}


def least_time_s(work, pk):
    """The least time the card needs for the math of ``work``: every FLOP
    at its precision's peak."""
    return (work["flops"]["float32"] / pk["float32"]
            + work["flops"]["bfloat16"] / pk["bfloat16"])


def solve_least_time_s(work, pk):
    """The solves' least time: for each solve layer the larger of its
    FLOPs at the float32 peak and its bytes at the memory bandwidth."""
    return sum(max(f / pk["float32"], b / pk["bytes_per_s"])
               for f, b in work["solves"])
