"""A coupling net's conv3x3 -> ReLU -> conv1x1 on one hand-written kernel
pair, the hidden activation kept on chip.

``coupling_net_hidden(x1, w1, w2)`` is conv2's pre-ReLU output of the net
``conv1x1(relu(conv3x3(x1, w1, padding=1)), w2)``: x1 (B, Cin, H, W), w1
(N, Cin, 3, 3), w2 (C, N, 1, 1), no biases; the result (B, C, H, W) is the
tensor that ``reduce_from_model`` sums under a mesh, so a tensor-parallel
net takes it on its rank's slice of the width unchanged.

A CPU tensor takes :func:`coupling_net_reference`, the ``F.conv2d``
composition. A float32 CUDA tensor launches ``csrc/coupling_net.cu``
through :class:`CouplingNet`, whose forward is one launch of the forward
kernel (one a group of 64 output channels; where the pixels give too few
tiles to fill the card, the hidden width splits over a cluster of blocks
that sum their partial outputs on chip) and saves only x1 and the two
weights; its backward is one launch of the backward kernel (it recomputes
the hidden activation tile by tile, over slices of the width where the
tiles are few) and one of the reduction (the weight gradients' per-block
partials in block order, and x1's gradient gathered from the per-pixel
patch gradients of each slice). Any other tensor raises. The launches
are counted in ``coupling_net_hidden.launches`` and
``.launches_by_kind`` (:data:`KINDS`); :func:`reset_launches` sets them
to 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

KINDS = ("forward", "backward", "reduce")
PLAN_KEYS = ("fwd_pixels", "fwd_chunk", "fwd_channels", "fwd_smem",
             "bwd_pixels", "bwd_chunk", "bwd_columns", "bwd_smem",
             "bwd_resident", "bwd_tiles", "fwd_launches", "bwd_w2_parts",
             "fwd_split", "bwd_split", "bwd_grid", "bwd_kind")


def coupling_net_reference(x1, w1, w2):
    """conv2's pre-ReLU output in plain PyTorch: the F.conv2d composition."""
    return F.conv2d(F.relu(F.conv2d(x1, w1, padding=1)), w2)


def _shape(x1, w1, w2):
    """(b, cin, h, w, n, c) of a call; raises on what the kernel does not
    take."""
    if x1.dim() != 4 or w1.dim() != 4 or w2.dim() != 4:
        raise ValueError("coupling_net_hidden: x1, w1 and w2 must be 4-d")
    b, cin, h, w = x1.shape
    n, c = w1.shape[0], w2.shape[0]
    if (tuple(w1.shape) != (n, cin, 3, 3)
            or tuple(w2.shape) != (c, n, 1, 1)):
        raise ValueError(
            f"coupling_net_hidden: unsupported shapes x1{tuple(x1.shape)} "
            f"w1{tuple(w1.shape)} w2{tuple(w2.shape)}: a 3x3 conv "
            f"Cin -> N, then a 1x1 conv N -> C")
    if b * h * w >= 2 ** 31:
        raise ValueError("coupling_net_hidden: more than 2^31 pixels")
    return b, cin, h, w, n, c


@functools.cache
def _plan(device_index, shape):
    from ._build import coupling_net_lib

    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = coupling_net_lib().coupling_net_plan(*shape, out)
    if err != 0:
        raise RuntimeError(f"coupling_net_plan{shape} failed with CUDA error "
                           f"{err} (too much shared memory at this shape?)")
    return dict(zip(PLAN_KEYS, out))


def plan(x1, w1, w2):
    """The kernels' plan at this call's shapes on x1's card: pixels a
    block and channels a chunk of each kernel, shared memory, the
    backward's resident blocks and tiles, and where the tiles do not fill
    the card, the splits of the width (the forward's blocks a cluster, the
    backward's slices) and the backward's grid of tile blocks."""
    with torch.cuda.device(x1.device):
        return _plan(x1.device.index, _shape(x1, w1, w2))


def composition_flops(x1, w1, w2, need_dx=True):
    """(forward, backward) FLOPs of the ``F.conv2d`` composition at this
    call's shapes, as ``FlopCounterMode`` counts them: 2 (K + C) N a
    pixel forward (K = 9 Cin); backward each conv's weight gradient and
    input gradient as many as its forward, conv1's input gradient only
    with ``need_dx``."""
    b, cin, h, w, n, c = _shape(x1, w1, w2)
    pn, k = 2 * b * h * w * n, 9 * cin
    return pn * (k + c), pn * (2 * c + k + (k if need_dx else 0))


def _x1_operand(x1):
    """x1 and its batch stride: a channel slice of a contiguous tensor is
    taken as it lies, anything else is copied."""
    b, cin, h, w = x1.shape
    if x1.stride()[1:] != (h * w, w, 1):
        x1 = x1.contiguous()
    return x1, x1.stride(0)


def _transposed(w):
    """A conv weight (O, I, kh, kw) as the (I kh kw) x O matrix, which the
    kernels stage by chunks of channels (one small copy a call)."""
    return w.reshape(w.shape[0], -1).t().contiguous()


def _check(x1, w1, w2):
    if x1.device.type != "cuda":
        raise ValueError(f"coupling_net_hidden: unsupported device "
                         f"{x1.device}")
    if any(t.device != x1.device for t in (w1, w2)):
        raise ValueError("coupling_net_hidden: inputs on different devices")
    if any(t.dtype != torch.float32 for t in (x1, w1, w2)):
        raise TypeError("coupling_net_hidden: the kernel takes float32 only")
    return _shape(x1, w1, w2)


def _count(kind, n=1):
    coupling_net_hidden.launches += n
    coupling_net_hidden.launches_by_kind[kind] += n


def _forward(x1, w1, w2):
    shape = _check(x1, w1, w2)
    b, cin, h, w, n, c = shape
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    x1, sb = _x1_operand(x1)
    w1t, w2t = _transposed(w1), _transposed(w2)
    from ._build import coupling_net_lib

    with torch.cuda.device(x1.device):
        p = _plan(x1.device.index, shape)
        err = coupling_net_lib().coupling_net_fwd_f32(
            x1.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), out.data_ptr(),
            *shape, sb, p["fwd_split"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"coupling_net_hidden: forward launch failed with "
                           f"CUDA error {err}")
    _count("forward", p["fwd_launches"])
    return out


def _backward(x1, w1, w2, g, need_dx):
    """(dx1 or None, dw1, dw2) of the net at x1 for the cotangent g."""
    shape = _check(x1, w1, w2)
    b, cin, h, w, n, c = shape
    dev = x1.device
    x1, sb = _x1_operand(x1)
    w1t, w2, g = _transposed(w1), w2.contiguous(), g.contiguous()
    if g.dtype != torch.float32 or tuple(g.shape) != (b, c, h, w):
        raise ValueError(f"coupling_net_hidden: cotangent "
                         f"{tuple(g.shape)} {g.dtype}")
    k = 9 * cin
    from ._build import coupling_net_lib

    lib = coupling_net_lib()
    with torch.cuda.device(dev):
        p = _plan(dev.index, shape)
        grid, split = p["bwd_grid"], p["bwd_split"]
        f32 = dict(dtype=torch.float32, device=dev)
        dpatch = torch.empty((split, k, b * h * w), **f32)
        part1 = torch.empty((grid, n, k), **f32)
        part2 = torch.empty((grid * p["bwd_w2_parts"], c, n), **f32)
        dw1 = torch.empty((n, cin, 3, 3), **f32)
        dw2 = torch.empty((c, n, 1, 1), **f32)
        dx1 = torch.empty((b, cin, h, w), **f32) if need_dx else None
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coupling_net_bwd_f32(
            x1.data_ptr(), w1t.data_ptr(), w2.data_ptr(), g.data_ptr(),
            dpatch.data_ptr(), part1.data_ptr(), part2.data_ptr(), grid,
            split, *shape, sb, stream)
        if err != 0:
            raise RuntimeError(f"coupling_net_hidden: backward launch failed "
                               f"with CUDA error {err}")
        _count("backward")
        err = lib.coupling_net_reduce_f32(
            part1.data_ptr(), part2.data_ptr(), dpatch.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(),
            dx1.data_ptr() if need_dx else None, grid, part2.shape[0],
            split, *shape, stream)
        if err != 0:
            raise RuntimeError(f"coupling_net_hidden: reduce launch failed "
                               f"with CUDA error {err}")
        _count("reduce")
    return dx1, dw1, dw2


class CouplingNet(torch.autograd.Function):
    """conv2's pre-ReLU output on the kernels; saves x1, w1 and w2 only."""

    @staticmethod
    def forward(ctx, x1, w1, w2):
        ctx.save_for_backward(x1, w1, w2)
        return _forward(x1, w1, w2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x1, w1, w2 = ctx.saved_tensors
        return _backward(x1, w1, w2, g, ctx.needs_input_grad[0])


def coupling_net_hidden(x1, w1, w2):
    """``conv1x1(relu(conv3x3(x1, w1, padding=1)), w2)``: the plain
    version on a CPU tensor, the kernels (:class:`CouplingNet`) on a CUDA
    one, which must be float32."""
    if x1.device.type == "cpu":
        return coupling_net_reference(x1, w1, w2)
    return CouplingNet.apply(x1, w1, w2)


def reset_launches():
    """Sets :func:`coupling_net_hidden`'s launch counts to 0."""
    coupling_net_hidden.launches = 0
    coupling_net_hidden.launches_by_kind = dict.fromkeys(KINDS, 0)


reset_launches()
