"""Chained multi-order inverse-conv solve on the hand-written chain kernel.

PyTorch port of ``inverse_flow_tpu/ops/fused_chain.py``. Each pad order
solves ``y = F_o^{-1} solve_TL(F_o x, w_o)`` with ``F_o`` a flip of H and/or
W. The flips are permutations that respect the row-blocked layout, so they
are absorbed into the solve matrices (conjugated by ``_rows_perm``), and an
H-flipped order scans its blocks top down and carries the first KH-1 rows
instead of the last. Every order then runs the same recurrence on
unflipped data:

    y_b = x_b @ T_eff^T - carry @ G_eff^T

:func:`chain_phases` runs it: on a CUDA tensor one of the kernels of
``csrc/chain_solve.cu`` (:func:`chain_variant` picks it from the block
width), and on a CPU tensor :func:`chain_phases_reference`, the same
function in plain torch. The operator build (:func:`_phase_matrices`) is
plain torch on either device, one batched pass over the N orders' kernels.

A grouped kernel (FincFlow's level 2, a grouped ``InvFlow``) enters the
chain as its dense block-diagonal expansion (:func:`expand_grouped_kernel`),
as in the JAX package.

The backward (:class:`FusedChainSolve`) is again a chain: the cotangent
walks the orders in reverse, each with its complementary orientation
(``_COMPLEMENT``: flip both axes) and its channel-transposed kernel, so the
same kernel runs it; the weight gradients are one conv weight-gradient per
order on the phase outputs that the forward launch keeps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from .inv_conv import (_block_toeplitz_inverse, _prev_block, _row_matrices,
                       _solve_wgrad, _transpose_kernel)

# (flip_h, flip_w) per pad order
ORDER_FLAGS = {
    "TL": (False, False),
    "TR": (False, True),
    "BL": (True, False),
    "BR": (True, True),
}

# flip2 . F_o: the orientation of order o's backward solve
_COMPLEMENT = {"TL": "BR", "TR": "BL", "BL": "TR", "BR": "TL"}

# the widest block row any kernel takes (csrc/chain_solve.cu:kMaxRcw)
MAX_RCW = 2048
# the cluster kernel (csrc/chain_solve.cu: kClusterSize, kMaxCols,
# kSmemLimit): 8 CTAs split the output columns, at most 64 each, and each
# holds its slices of T and G and its staging rows in shared memory
CLUSTER_SIZE = 8
CLUSTER_ROWS = 8
CLUSTER_MAX_COLS = 64
SMEM_LIMIT = 232448
# the wide cluster kernel (csrc/chain_solve.cu: kWideCluster, kWideChunks,
# kWideMaxStages): 16 CTAs split the columns, a cluster takes 1-4 groups
# of 8 batch rows, and T's and G's slices are held for a phase or streamed
# in chunks of 256, 128 or 64 k-columns
WIDE_CLUSTER_SIZE = 16
WIDE_CHUNKS = (256, 128, 64)
WIDE_MAX_STAGES = 8


def choose_block_rows_fused(h: int, cw: int, kh: int):
    """(rows per block, zero-padded tail rows), or None when no block size
    with at least two blocks exists (then :func:`chain_inputs` runs the
    chain as one block of H rows).

    H need not be a multiple of R: the last block's tail is zero-padded and
    re-zeroed after every phase. Exact divisors are preferred; R >= KH-1
    so a block reaches back at most one block; R*CW near 512."""
    cands = list(range(max(kh - 1, 1), h))      # r < h  =>  nb >= 2
    if not cands:
        return None
    fitting = [r for r in cands if r * cw <= 1024]
    pool = fitting or [min(cands)]
    divisors = [r for r in pool if h % r == 0]
    r = min(divisors or pool, key=lambda r: (abs(r * cw - 512), (-h) % r))
    return r, (-h) % r


# ---------------------------------------------------------------------------
# Permutation-conjugated solve matrices
# ---------------------------------------------------------------------------

def _cw_perm(width, c, fw, device):
    i = torch.arange(width * c, device=device)
    if not fw:
        return i
    return (width - 1 - i // c) * c + i % c


def flip_to(x, order):
    """NCHW ``x`` flipped into ``order``'s orientation (H when it flips
    H, W when it flips W); the flips are involutions, so the same call
    flips back."""
    ax = tuple(a for a, f in zip((2, 3), ORDER_FLAGS[order]) if f)
    return x.flip(ax) if ax else x


def _rows_perm(rows, width, c, fh, fw, device):
    """Permutation of ``rows`` flattened (w, c) row vectors: reverse the
    rows when ``fh``, the pixels within each row when ``fw``."""
    cw = width * c
    i = torch.arange(rows * cw, device=device)
    rr, ii = i // cw, i % cw
    rn = (rows - 1 - rr) if fh else rr
    return rn * cw + _cw_perm(width, c, fw, device)[ii]


def _phase_matrices(w_effs, orders, width, r, kcw):
    """(T_eff (N, RCW, RCW), G_eff (N, RCW, KCW)) for N orders: the
    blocked solve matrices of all N kernels from one batched build, each
    conjugated by its order's flip permutations, so the kernel runs on
    unflipped data."""
    c, kh = w_effs[0].shape[0], w_effs[0].shape[2]
    mats = _row_matrices(torch.stack(w_effs), width)
    t_inv = _block_toeplitz_inverse(mats, r)
    g = t_inv @ _prev_block(mats, r)
    dev = t_inv.device
    q = torch.stack([_rows_perm(r, width, c, *ORDER_FLAGS[o], dev)
                     for o in orders])
    s = torch.stack([_rows_perm(kh - 1, width, c, *ORDER_FLAGS[o], dev)
                     for o in orders])[:, :kcw]
    n = torch.arange(len(orders), device=dev)[:, None, None]
    return (t_inv[n, q[:, :, None], q[:, None, :]],
            g[n, q[:, :, None], s[:, None, :]])


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _to_blocks(x, r):
    """NCHW -> (NB, B, R*CW), rows flattened (w, c)."""
    b, c, h, width = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(b, h // r, r * width * c)
    return rows.transpose(0, 1).contiguous()


def _from_blocks(yb, c, h, width):
    """(NB, B, R*CW) -> NCHW."""
    b = yb.shape[1]
    rows = yb.transpose(0, 1).reshape(b, h, width, c)
    return rows.permute(0, 3, 1, 2)


def _from_blocks_trim(yb, c, h, width):
    """(NB, B, RCW) -> NCHW, dropping zero-padded tail rows beyond H."""
    nb, _, rcw = yb.shape
    h_pad = nb * (rcw // (width * c))
    y = _from_blocks(yb, c, h_pad, width)
    return y[:, :, :h] if h_pad != h else y


# ---------------------------------------------------------------------------
# The recurrence: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def chain_phases_reference(xb, t_all, g_all, dirs, kcw, pad_cw=0):
    """Plain torch version of :func:`chain_phases`: the stacked outputs
    (N, NB, B, RCW) of every phase."""
    nb, b, rcw = xb.shape
    keep = torch.arange(rcw, device=xb.device) < rcw - pad_cw
    src, phases = xb, []
    for o, flip_h in enumerate(dirs):
        carry = xb.new_zeros((b, kcw))
        ys = [None] * nb
        for i in range(nb):
            m = nb - 1 - i if flip_h else i
            v = src[m] @ t_all[o].T - carry @ g_all[o].T
            if pad_cw and m == nb - 1:
                v = torch.where(keep, v, 0.0)
            ys[m] = v
            carry = v[:, :kcw] if flip_h else v[:, rcw - kcw:]
        src = torch.stack(ys)
        phases.append(src)
    return torch.stack(phases)


def _round4(v):
    return -(-v // 4) * 4


def _pad16(v):
    return -(-(v + 16) // 32) * 32 - 16


def _cluster_cols(rcw):
    """Output columns per CTA of the cluster kernel: ceil(RCW / 8) rounded
    up to a multiple of 4."""
    return _round4(-(-rcw // CLUSTER_SIZE))


def cluster_smem_bytes(rcw, kcw):
    """The cluster kernel's shared memory at block width ``rcw`` and carry
    width ``kcw``: a 16-byte mbarrier, then T's and G's slices (one row
    per output column of a CTA, :func:`_cluster_cols`; row strides 16
    floats past a multiple of 32), two buffers of 8 input rows and one of
    8 carry rows (rows padded to a multiple of 4 floats), two of the CTA's
    8 rows of outputs, and 8 warps x 512 partial sums
    (``csrc/chain_solve.cu:cluster_smem_floats``)."""
    cols = _cluster_cols(rcw)
    floats = (cols * (_pad16(rcw) + _pad16(kcw))
              + CLUSTER_ROWS * (2 * _round4(rcw) + _round4(kcw))
              + 2 * CLUSTER_ROWS * cols + 8 * CLUSTER_MAX_COLS * CLUSTER_ROWS)
    return 16 + 4 * floats


def _wide_cols(rcw):
    """Output columns per CTA of the wide cluster kernel: ceil(RCW / 16)
    rounded up to a multiple of 4 (in passes of at most 64)."""
    return _round4(-(-rcw // WIDE_CLUSTER_SIZE))


def cluster_wide_layout(rcw, kcw, groups=1):
    """(chunk buffers, k-columns a chunk, shared memory bytes) of the wide
    cluster kernel at block width ``rcw``, carry width ``kcw`` and
    ``groups`` row groups of 8 a cluster; 0 buffers (and chunk 0): T's and
    G's slices are resident for a phase; None when the groups do not fit
    in 227 KB (``csrc/chain_solve.cu:wide_plan``). Its buffers: a 16-byte
    mbarrier; 8 x groups input rows and carry rows (padded to 4 floats)
    and two buffers of the CTA's outputs for them; 8 warps x 512 partial
    sums; then either the slices (row strides 16 past a multiple of 32
    floats), when a CTA has at most 64 columns and they fit, or as many
    chunk buffers as fit, up to 8, of the widest chunk (256, 128, 64
    k-columns) of which 2 fit, each min(columns, 64) rows (stride 16 past
    a multiple of 32)."""
    cols = _wide_cols(rcw)
    fixed = (CLUSTER_ROWS * groups * (_round4(rcw) + _round4(kcw) + 2 * cols)
             + 8 * CLUSTER_MAX_COLS * CLUSTER_ROWS)
    avail = (SMEM_LIMIT - 16) // 4 - fixed
    if avail <= 0:
        return None
    slices = cols * (_pad16(rcw) + _pad16(kcw))
    if cols <= CLUSTER_MAX_COLS and slices <= avail:
        return 0, 0, 16 + 4 * (fixed + slices)
    for chunk in WIDE_CHUNKS:
        stage = min(cols, CLUSTER_MAX_COLS) * _pad16(chunk)
        stages = min(WIDE_MAX_STAGES, avail // stage)
        if stages >= 2:
            return stages, chunk, 16 + 4 * (fixed + stages * stage)
    return None


def chain_variant(rcw, kcw):
    """Which kernel :func:`chain_phases` launches at block width ``rcw``
    and carry width ``kcw``: ``"cluster"`` when a CTA's slices of T and G
    fit in shared memory with its staging rows (at most 64 columns a CTA
    and :func:`cluster_smem_bytes` within 227 KB), else ``"cluster_wide"``
    (every shape with 0 < KCW <= RCW <= 2048). Raises on a shape neither
    takes. ``"streaming"``, the first design, is only ever forced."""
    if not 0 < kcw <= rcw <= MAX_RCW:
        raise ValueError(f"chain_variant: no kernel takes rcw={rcw} "
                         f"kcw={kcw}")
    if (_cluster_cols(rcw) <= CLUSTER_MAX_COLS
            and cluster_smem_bytes(rcw, kcw) <= SMEM_LIMIT):
        return "cluster"
    return "cluster_wide"


VARIANTS = ("cluster", "cluster_wide", "streaming")
_LAUNCHERS = {"cluster": "chain_phases_cluster_f32",
              "cluster_wide": "chain_phases_cluster_wide_f32",
              "streaming": "chain_phases_f32"}


def chain_phases(xb, t_all, g_all, dirs, kcw, pad_cw=0, variant=None):
    """All phase outputs (N, NB, B, RCW) of the chain recurrence.

    ``xb`` (NB, B, RCW), ``t_all`` (N, RCW, RCW), ``g_all`` (N, RCW, KCW),
    float32; ``dirs[o]`` is True when order o flips H (scans top down);
    the last ``pad_cw`` columns of the last block are zero-padded rows.
    CPU tensors take :func:`chain_phases_reference`; CUDA tensors launch
    the kernel that :func:`chain_variant` picks, or ``variant`` when given
    (tests and timings force one). ``chain_phases.launches`` counts the
    launches and ``chain_phases.launches_by_variant`` splits them."""
    with span("ift.solve.chain"):
        if variant is not None and variant not in VARIANTS:
            raise ValueError(f"chain_phases: unknown variant {variant!r}")
        if xb.device.type == "cpu":
            return chain_phases_reference(xb, t_all, g_all, dirs, kcw, pad_cw)
        if xb.device.type != "cuda":
            raise ValueError(f"chain_phases: unsupported device {xb.device}")
        nb, b, rcw = xb.shape
        n = len(dirs)
        tensors = (xb, t_all, g_all)
        if any(t.device != xb.device for t in tensors):
            raise ValueError("chain_phases: inputs on different devices")
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError("chain_phases: the kernel takes float32 only")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("chain_phases: inputs must be contiguous")
        if not (1 <= n <= 4 and 0 < kcw <= rcw <= MAX_RCW and 0 <= pad_cw < rcw
                and nb >= 1 and b >= 1
                and t_all.shape == (n, rcw, rcw)
                and g_all.shape == (n, rcw, kcw)):
            raise ValueError(
                f"chain_phases: unsupported shapes x{tuple(xb.shape)} "
                f"T{tuple(t_all.shape)} G{tuple(g_all.shape)} n={n} "
                f"kcw={kcw} pad_cw={pad_cw}")
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "chain_phases: the raw kernel call has no autograd; use "
                "fused_chain_solve, whose backward launches the kernel again")
        from ._build import chain_solve_lib

        variant = variant or chain_variant(rcw, kcw)
        y = torch.empty((n, nb, b, rcw), dtype=torch.float32, device=xb.device)
        dirs_mask = sum(1 << o for o, flip_h in enumerate(dirs) if flip_h)
        with torch.cuda.device(xb.device):
            lib = chain_solve_lib(xb.device.index)
            launch = getattr(lib, _LAUNCHERS[variant])
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(xb.data_ptr(), t_all.data_ptr(), g_all.data_ptr(),
                         y.data_ptr(), n, nb, b, rcw, kcw, pad_cw, dirs_mask,
                         stream)
        if err != 0:
            raise RuntimeError(f"chain_phases: {variant} kernel launch failed "
                               f"with CUDA error {err}")
        # on the function itself, not through the module's name, which a
        # caller may have bound to a wrapper around it
        _CHAIN_PHASES.launches += 1
        _CHAIN_PHASES.launches_by_variant[variant] += 1
        return y


_CHAIN_PHASES = chain_phases


def chain_work(args):
    """(multiply-adds per batch row, bytes) of one :func:`chain_phases`
    launch on ``args``, counted from that launch's operands.

    Multiply-adds: at every block step, for each live output column, the
    nonzero entries of its row of T but a diagonal 1 (T is a permuted
    triangle: a unit diagonal is a copy, an Emerging kernel's is a
    product, and the upper half is zero), and, after a scan's first
    block, of its row of G; each only over the live columns it multiplies
    (a padded tail column is always zero). Bytes: the live columns of x
    read and of every phase output written once, and those entries of T
    and the nonzero entries of G read once."""
    xb, t_all, g_all, dirs, kcw, pad_cw = args
    nb, _, rcw = xb.shape
    dev = t_all.device
    t_nz = (t_all != 0) & ~(torch.eye(rcw, dtype=torch.bool, device=dev)
                            & (t_all == 1))
    g_nz = g_all != 0
    full = torch.ones(rcw, dtype=torch.bool, device=dev)
    tail = torch.arange(rcw, device=dev) < rcw - pad_cw
    fma = 0
    for o, flip_h in enumerate(dirs):
        prev = None
        for i in range(nb):
            m = nb - 1 - i if flip_h else i
            live = tail if m == nb - 1 else full
            fma += int(t_nz[o][live][:, live].sum())
            if prev is not None:
                carried = prev[:kcw] if flip_h else prev[rcw - kcw:]
                fma += int(g_nz[o][live][:, carried].sum())
            prev = live
    live_cols = nb * rcw - pad_cw
    n_bytes = 4 * ((1 + len(dirs)) * xb.shape[1] * live_cols
                   + int(t_nz.sum()) + int(g_nz.sum()))
    return fma, n_bytes


def reset_launches():
    """Sets :func:`chain_phases`' launch counts to 0."""
    _CHAIN_PHASES.launches = 0
    _CHAIN_PHASES.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_launches()


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------

def chain_inputs(x, w_effs, orders):
    """The arguments of :func:`chain_phases` for solving ``x`` (B, C, H, W)
    through the chain: ``(xb, t_all, g_all, dirs, kcw, pad_cw)``; the N
    orders' operators come from one batched build. Row
    blocks cover the zero-padded height ceil(H/R)*R. A height with no
    split into two blocks of at least KH-1 rows runs as one block of H
    rows: no carry is read, so its width is capped at the block's."""
    with span("ift.solve.build"):
        b, c, h, width = x.shape
        kh = w_effs[0].shape[2]
        r, pad = choose_block_rows_fused(h, c * width, kh) or (h, 0)
        kcw = min((kh - 1) * c * width, r * c * width)
        t_all, g_all = _phase_matrices(tuple(w_effs), orders, width, r, kcw)
        dirs = tuple(ORDER_FLAGS[o][0] for o in orders)
        xb = _to_blocks(F.pad(x.float(), (0, 0, 0, pad)), r)
        return xb, t_all, g_all, dirs, kcw, pad * c * width


def backward_inputs(gy, w_effs, orders):
    """The arguments of the backward's :func:`chain_phases` launch: the
    cotangent ``gy`` through the orders in reverse, each with its
    complementary orientation and its channel-transposed kernel. Phase
    ``n-1-l`` of that launch is the cotangent on the input of order
    ``l``."""
    return chain_inputs(gy, tuple(_transpose_kernel(w)
                                  for w in reversed(w_effs)),
                        tuple(_COMPLEMENT[o] for o in reversed(orders)))


class FusedChainSolve(torch.autograd.Function):
    """The chain solve with its hand-written VJP, for N <= 4 orders.

    Port of ``_fused_fwd``/``_fused_bwd``. forward: one
    :func:`chain_phases` launch; every phase output is kept. backward: a
    second launch on :func:`backward_inputs`; then ``dW_l = -wgrad(y_l,
    dx_l)`` in order ``l``'s canonical (TL) frame."""

    @staticmethod
    def forward(ctx, orders, x, *w_effs):
        phases = chain_phases(*chain_inputs(x, w_effs, orders))
        ctx.orders, ctx.x_shape = orders, x.shape
        ctx.save_for_backward(phases, *w_effs)
        _, c, h, width = x.shape
        return _from_blocks_trim(phases[-1], c, h, width)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        phases, *w_effs = ctx.saved_tensors
        orders = ctx.orders
        _, c, h, width = ctx.x_shape
        n = len(orders)
        kh, kw = w_effs[0].shape[2], w_effs[0].shape[3]
        gphases = chain_phases(*backward_inputs(gy, w_effs, orders))
        dws = []
        for l, order in enumerate(orders):
            dx_l = flip_to(_from_blocks_trim(gphases[n - 1 - l], c, h,
                                             width), order)
            y_l = flip_to(_from_blocks_trim(phases[l], c, h, width), order)
            dws.append(_solve_wgrad(y_l, dx_l, kh, kw))
        dx = _from_blocks_trim(gphases[-1], c, h, width)
        return (None, dx, *dws)


def expand_grouped_kernel(w_eff, groups: int):
    """The dense (C, C, KH, KW) kernel of a grouped one ``w_eff`` (C,
    C/groups, KH, KW): the group blocks on the channel block-diagonal,
    zeros elsewhere, so that the chain solves a grouped conv (FincFlow's
    level 2: four orders' chunks in one launch) as an ungrouped one. A
    product with the identity over the groups, not a scatter into a
    buffer: autograd carries the dense kernel's gradient back to the
    group blocks only."""
    if groups == 1:
        return w_eff
    c, cg = w_eff.shape[0], w_eff.shape[0] // groups
    taps = w_eff.shape[2:]
    wg = w_eff.reshape(groups, cg, 1, cg, *taps)
    eye = torch.eye(groups, dtype=w_eff.dtype, device=w_eff.device)
    return (wg * eye.reshape(groups, 1, groups, 1, 1, 1)).reshape(c, c,
                                                                  *taps)


def fused_chain_solve(x, w_effs, orders):
    """``y = (solve_{o_n} . ... . solve_{o_1})(x)``: each ``solve_o`` is the
    orientation-``o`` inverse of the masked conv with (already masked)
    kernel ``w_effs[i]``. For masked kernels (``apply_mask``) every factor
    is unit triangular and the chain's ldj is 0; an Emerging
    autoregressive kernel has a non-unit diagonal, which the solve takes
    too (its ldj is the layer's own). Differentiable in ``x`` and ``w_effs`` through
    :class:`FusedChainSolve`. Raises on a shape the kernel does not
    take."""
    return FusedChainSolve.apply(tuple(orders), x, *w_effs)
