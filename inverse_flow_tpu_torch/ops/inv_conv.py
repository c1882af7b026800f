"""Inverse of a masked convolution: masking, the masked conv, and the
row-blocked operator build that the chain solve runs on.

PyTorch port of ``inverse_flow_tpu/ops/inv_conv.py`` (the subset the
training path needs). In raster order the masked conv ``T`` is block-banded
lower triangular, so ``y = T^{-1} x`` is solved row-blocked:

  1. per-row dependence matrices ``mats`` (KH, CW, CW) from the kernel;
  2. the R-row block operator inverted structurally (block-Toeplitz
     recurrence from ``M0^{-1}``) and the coupling map ``G = T_blk^{-1} P``
     to the previous block's last KH-1 rows;
  3. ``y_b = x_b @ T_blk^{-T} - tail_{b-1} @ G^T`` over the row blocks.

Steps 1-2 take a leading order axis: the N kernels of a chain (the four of
an ``InvFlowUnit``) are built in one batched pass, as the JAX
``_chain_build`` vmaps them. Step 3 runs in the chain kernel
(``ops/fused_chain.py``); :func:`solve_ungrouped` here is the plain
composition, kept as a second reference beside :func:`masked_conv_apply`
and :func:`dense_operator`.

Rows are flattened as (w, c) -> w*C + c, so ``M0`` is block-lower over
pixels with a unit diagonal (an Emerging autoregressive kernel's diagonal
is its own). Its diagonal (C, C) blocks are lower triangular for a
canonically masked kernel and upper triangular for its channel transpose,
the kernel of the backward solve.

The solve's VJP (the JAX ``_inv_conv_bwd``) is again a solve:
``dx = T^{-T} g`` is the BR-oriented solve of ``g`` with the
channel-transposed kernel (:func:`_transpose_kernel`), and
``dW = -wgrad(y_padTL, dx)`` (:func:`_solve_wgrad`), a convolution with the
batch as the contraction.

The Jacobi solves (:func:`inv_conv_solve_jacobi`,
:func:`inv_conv_solve_jacobi_guarded` and their implicit-VJP forms) take
no operator build and no scan: each iteration is one masked conv, plain
torch (the JAX package runs them as XLA convs in a ``fori_loop``). Where
JAX decides on the device (``lax.while_loop``, ``lax.cond``), the port
reads one value on the host, and counts each such sync.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

def center_mask(c_out: int, c_in: int, kh: int, kw: int, device=None):
    """(mask, center_eye): ``w * mask + center_eye`` has
    ``w[c, c, -1, -1] = 1`` and ``w[c, c' > c, -1, -1] = 0`` (canonical TL
    orientation)."""
    mask = torch.ones((c_out, c_in, kh, kw), device=device)
    tri = torch.ones((c_out, c_in), device=device).triu()     # diag + upper
    mask[:, :, -1, -1] -= tri
    eye = torch.zeros((c_out, c_in, kh, kw), device=device)
    eye[:, :, -1, -1] = torch.eye(c_out, c_in, device=device)
    return mask, eye


def apply_mask(w):
    """``w_eff = w*mask + I_center``: unit-lower-triangular center tap.

    Requires a square kernel: on a rectangular one the center eye would
    cover only part of the channels and leave a singular operator."""
    if w.shape[0] != w.shape[1]:
        raise ValueError(
            f"apply_mask expects a square per-group kernel, got "
            f"{tuple(w.shape)}")
    mask, eye = center_mask(*w.shape, device=w.device)
    return w * mask + eye


# ---------------------------------------------------------------------------
# The masked convolution itself (the inverse direction, test oracle)
# ---------------------------------------------------------------------------

def masked_conv_apply(y, w_eff, groups: int = 1):
    """``z = T y``: conv with TL zero padding (KH-1 top, KW-1 left);
    ``w_eff`` (C, C/groups, KH, KW) for a grouped conv."""
    kh, kw = w_eff.shape[2], w_eff.shape[3]
    return F.conv2d(F.pad(y, (kw - 1, 0, kh - 1, 0)), w_eff, groups=groups)


def dense_operator(w_eff, c: int, h: int, width: int, groups: int = 1):
    """``T`` as a dense (CHW, CHW) matrix in flattened NCHW order, so that
    ``T @ y.reshape(-1)`` is ``masked_conv_apply(y, w_eff, groups)`` for
    one image (the JAX ``dense_operator``). A test oracle and the library
    call's operand; never on the training path."""
    n = c * h * width
    eye = torch.eye(n, dtype=w_eff.dtype, device=w_eff.device)
    cols = masked_conv_apply(eye.reshape(n, c, h, width), w_eff, groups)
    return cols.reshape(n, n).T


# ---------------------------------------------------------------------------
# Operator build
# ---------------------------------------------------------------------------

def _row_matrices(w_eff, width: int):
    """(N, KH, CW, CW) stacks of per-row dependence matrices of N kernels
    ``w_eff`` (N, C, C', KH, KW). Index r=0 is the within-row matrix M0;
    r>=1 maps row h-r into row h:

      entry[n, r, (wi, c), (wj, c')] = w_eff[n, c, c', KH-1-r, KW-1-(wi-wj)]
                                       for 0 <= wi-wj <= KW-1, else 0.
    """
    n, c_out, c_in, kh, kw = w_eff.shape
    idx = torch.arange(width, device=w_eff.device)
    diff = idx[:, None] - idx[None, :]                          # (W, W)
    valid = (diff >= 0) & (diff <= kw - 1)
    tap = kw - 1 - diff.clamp(0, kw - 1)
    gathered = w_eff.flip(3)[..., tap]              # (N, C, C', KH, W, W)
    gathered = gathered * valid.to(w_eff.dtype)
    mats = gathered.permute(0, 3, 4, 1, 5, 2)       # (N, KH, W, C, W, C')
    return mats.reshape(n, kh, width * c_out, width * c_in)


def _choose_block_rows(h: int, cw: int, kh: int) -> int:
    """Rows per block for :func:`solve_ungrouped`: about 384 columns wide,
    at most 1024, and R >= KH-1 so inter-block dependence reaches back
    exactly one block."""
    r = max(kh - 1, 1, min(h, -(-384 // cw)))
    while r > max(kh - 1, 1) and r * cw > 1024:
        r -= 1
    return min(r, h)


def _tri_inverse(m0):
    """Exact ``M0^{-1}`` for each elementwise-triangular ``M0`` of a stack
    (..., CW, CW): the within-row matrix of a masked kernel (unit lower),
    of its channel transpose (unit upper within the diagonal blocks) and
    of an Emerging autoregressive kernel (a non-unit diagonal) alike.

    ``M0 = D (I + N)`` with ``D = diag(M0)`` and ``N`` nilpotent; the unit
    factor is inverted by Newton-Schulz ``X <- X (2I - M X)`` from ``X =
    2I - M``: after k steps X is ``sum_{j < 2^(k+1)} (-N)^j``, which is
    exact once ``2^(k+1) >= CW``; then ``M0^{-1} = X D^{-1}``, as the JAX
    package's generic branch. Chosen over a general LU
    (``torch.linalg.inv``) because it is matmuls only: the same ops on
    the CPU and the card, no pivoting and no host sync."""
    n = m0.shape[-1]
    d = torch.diagonal(m0, dim1=-2, dim2=-1)
    m_unit = m0 / d[..., :, None]
    eye2 = 2.0 * torch.eye(n, dtype=m0.dtype, device=m0.device)
    x = eye2 - m_unit
    for _ in range(max(1, (n - 1).bit_length() - 1)):
        x = x @ (eye2 - m_unit @ x)
    return x / d[..., None, :]


def _toeplitz_d_blocks(mats, r_rows: int):
    """(N, R, CW, CW) blocks of each ``T_blk^{-1}`` (KH >= 2): block
    (i, j) is ``D[i-j]`` (zero above the diagonal), with
    ``D[0] = M0^{-1}`` and ``D[d] = -M0^{-1} sum_{r=1..min(KH-1,d)}
    mats[r] D[d-r]``."""
    kh = mats.shape[1]
    m0_inv = _tri_inverse(mats[:, 0])
    d_blocks = [m0_inv]
    for d in range(1, r_rows):
        acc = sum(mats[:, r] @ d_blocks[d - r]
                  for r in range(1, min(kh - 1, d) + 1))
        d_blocks.append(-(m0_inv @ acc))
    return torch.stack(d_blocks, dim=1)


def _block_toeplitz_inverse(mats, r_rows: int):
    """Dense (N, R*CW, R*CW) ``T_blk^{-1}`` assembled from the D blocks."""
    n, cw = mats.shape[0], mats.shape[2]
    stack = _toeplitz_d_blocks(mats, r_rows)
    i = torch.arange(r_rows, device=mats.device)
    q = i[:, None] - i[None, :]
    gathered = stack[:, q.clamp(0, r_rows - 1)]         # (N, R, R, CW, CW)
    gathered = gathered * (q >= 0).to(mats.dtype)[:, :, None, None]
    return gathered.permute(0, 1, 3, 2, 4).reshape(n, r_rows * cw,
                                                   r_rows * cw)


def _prev_block(mats, r_rows: int):
    """(N, R*CW, (KH-1)*CW) maps from the previous block's last KH-1 rows
    (tail[t] = y at block row R-(KH-1)+t) into this block's rows:
    block (i, t) = mats[i + KH-1 - t] when 1 <= i+KH-1-t <= KH-1."""
    n, kh, cw = mats.shape[0], mats.shape[1], mats.shape[2]
    i = torch.arange(r_rows, device=mats.device)
    t = torch.arange(kh - 1, device=mats.device)
    q = i[:, None] + (kh - 1) - t[None, :]
    valid = (q >= 1) & (q <= kh - 1)
    gathered = mats[:, q.clamp(0, kh - 1)]          # (N, R, KH-1, CW, CW)
    gathered = gathered * valid.to(mats.dtype)[:, :, None, None]
    return gathered.permute(0, 1, 3, 2, 4).reshape(n, r_rows * cw,
                                                   (kh - 1) * cw)


# ---------------------------------------------------------------------------
# Plain solve: y = T^{-1} x (second reference for the chain kernel)
# ---------------------------------------------------------------------------

def _scan_blocks(c_all, g, kcw: int):
    """``y_n = c_n - tail @ G^T`` over the blocks, tail = last KH-1 rows
    of ``y_{n-1}``."""
    b, nb, rcw = c_all.shape
    tail = c_all.new_zeros((b, kcw))
    ys = []
    for n in range(nb):
        y_n = c_all[:, n] - tail @ g.T
        ys.append(y_n)
        tail = y_n[:, rcw - kcw:]
    return torch.stack(ys, dim=1)


def solve_ungrouped(x, w_eff):
    """Solve ``T(w_eff) y = x`` (TL orientation, KH >= 2) with plain torch
    ops."""
    b, c, h, width = x.shape
    kh = w_eff.shape[2]
    cw = c * width
    mats = _row_matrices(w_eff[None], width)
    r = _choose_block_rows(h, cw, kh)
    nb = -(-h // r)
    rcw, kcw = r * cw, (kh - 1) * cw
    t_inv = _block_toeplitz_inverse(mats, r)[0]
    x_rows = x.permute(0, 2, 3, 1).reshape(b, h, cw)
    xb = F.pad(x_rows, (0, 0, 0, nb * r - h)).reshape(b, nb, rcw)
    c_all = xb @ t_inv.T
    if nb > 1:
        c_all = _scan_blocks(c_all, t_inv @ _prev_block(mats, r)[0], kcw)
    y_rows = c_all.reshape(b, nb * r, cw)[:, :h]
    return y_rows.reshape(b, h, width, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Backward pieces: transposed kernel and weight gradient
# ---------------------------------------------------------------------------

def _transpose_kernel(w_eff, groups: int = 1):
    """Channel transpose within each group's (C/g, C/g) block: the kernel
    of ``T^T``'s solve."""
    if groups == 1:
        return w_eff.transpose(0, 1)
    c, cg = w_eff.shape[0], w_eff.shape[1]
    wg = w_eff.reshape(groups, cg, cg, *w_eff.shape[2:]).transpose(1, 2)
    return wg.reshape(c, cg, *w_eff.shape[2:])


def _solve_wgrad(y, dx, kh: int, kw: int, groups: int = 1):
    """``dW = -wgrad(y_padTL, dx)``: the weight cotangent of ``y = T^{-1}
    x`` given ``dx = T^{-T} g``; ``dK[c, c', a, b] = sum_{n, h, w}
    dx[n, c, h, w] * y_pad[n, c', h+a, w+b]``, in float32, each group's
    block on its own channels."""
    y_pad = F.pad(y, (kw - 1, 0, kh - 1, 0))
    return -torch.nn.grad.conv2d_weight(
        y_pad, (dx.shape[1], y.shape[1] // groups, kh, kw), dx,
        groups=groups)


# ---------------------------------------------------------------------------
# Jacobi (Neumann-series) solve: every iteration one masked conv
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_convs():
    """cuDNN convs in full float32 (TF32 off) for the duration: the
    guard's tolerance sits above the float32 step-difference floor, which
    TF32's 10-bit mantissa would raise past it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _jacobi_step(x, y, w_eff, groups):
    """``x - (T y - y)``; its difference from ``y`` is the residual
    ``x - T y``."""
    return x - (masked_conv_apply(y, w_eff, groups) - y)


def inv_conv_solve_jacobi(x, w_eff, groups: int = 1, iters: int = 12,
                          tol: float = 0.0):
    """Approximate ``T^{-1} x`` by the fixed-point iteration ``y_{k+1} =
    x - (T - I) y_k`` from ``y_0 = x`` (the JAX
    ``inv_conv_solve_jacobi``): ``iters`` masked convs, no sequential
    scan over the rows. ``T - I`` is strictly lower triangular in raster
    order, so the series is exact after C/g*H*W iterations and converges
    geometrically in ``||T - I||``.

    ``tol > 0`` stops early once ``max|y_{k+1} - y_k| < tol``: the JAX
    ``lax.while_loop`` decides on the device; here each iteration reads
    the maximum on the host, one sync counted in
    ``inv_conv_solve_jacobi.syncs``."""
    with _fp32_convs():
        y = x
        for _ in range(iters):
            y_next = _jacobi_step(x, y, w_eff, groups)
            if tol > 0.0:
                inv_conv_solve_jacobi.syncs += 1
                if ((y_next - y).abs().max() < tol).item():
                    return y_next
            y = y_next
        return y


def inv_conv_solve_jacobi_guarded(x, w_eff, groups: int = 1,
                                  fast_iters: int = 12,
                                  cap_iters: int = 128,
                                  tol: float = 1e-3):
    """The residual-guarded Jacobi solve (the JAX
    ``inv_conv_solve_jacobi_guarded``): ``fast_iters`` iterations, one
    more whose step difference is the true residual ``x - T y``, and only
    when ``max|residual| >= tol * (1 + max|x|)`` the fallback: iterations
    up to ``cap_iters`` in all (exact once ``cap_iters`` reaches the
    nilpotency index C/g*H*W). JAX decides with ``lax.cond`` on the
    device; here the decision is one host sync per solve, counted in
    ``inv_conv_solve_jacobi_guarded.syncs``, and each fallback in
    ``.fallbacks``."""
    with _fp32_convs():
        y = x
        for _ in range(fast_iters):
            y = _jacobi_step(x, y, w_eff, groups)
        y_next = _jacobi_step(x, y, w_eff, groups)
        ok = (y_next - y).abs().max() < tol * (1.0 + x.abs().max())
        inv_conv_solve_jacobi_guarded.syncs += 1
        if ok.item():
            return y_next
        inv_conv_solve_jacobi_guarded.fallbacks += 1
        for _ in range(max(cap_iters - fast_iters - 1, 0)):
            y_next = _jacobi_step(x, y_next, w_eff, groups)
        return y_next


def reset_jacobi_counts():
    """Sets the Jacobi solves' sync and fallback counts to 0."""
    inv_conv_solve_jacobi.syncs = 0
    inv_conv_solve_jacobi_guarded.syncs = 0
    inv_conv_solve_jacobi_guarded.fallbacks = 0


reset_jacobi_counts()


def _jacobi_forward(ctx, solve, x, w_eff, groups, *args):
    y = solve(x, w_eff, groups, *args)
    ctx.groups, ctx.args = groups, args
    ctx.save_for_backward(y, w_eff)
    return y


def _jacobi_backward(ctx, solve, g):
    """The implicit-function VJP of both Jacobi solves (the JAX
    ``_jacobi_bwd``/``_jacobi_guarded_bwd``): ``dx = T^{-T} g`` solves the
    flipped cotangent by the same iteration on the channel-transposed
    kernel, ``dW = -wgrad(y, dx)``; no iterate is kept, whatever the
    number of iterations."""
    y, w_eff = ctx.saved_tensors
    dx = solve(g.flip((2, 3)), _transpose_kernel(w_eff, ctx.groups),
               ctx.groups, *ctx.args).flip((2, 3))
    dw = _solve_wgrad(y, dx, w_eff.shape[2], w_eff.shape[3], ctx.groups)
    return (dx, dw, None) + (None,) * len(ctx.args)


class JacobiSolve(torch.autograd.Function):
    """:func:`inv_conv_solve_jacobi` with its implicit-function VJP."""

    @staticmethod
    def forward(ctx, x, w_eff, groups, iters, tol):
        return _jacobi_forward(ctx, inv_conv_solve_jacobi, x, w_eff, groups,
                               iters, tol)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _jacobi_backward(ctx, inv_conv_solve_jacobi, g)


class GuardedJacobiSolve(torch.autograd.Function):
    """:func:`inv_conv_solve_jacobi_guarded` with its implicit-function
    VJP."""

    @staticmethod
    def forward(ctx, x, w_eff, groups, fast_iters, cap_iters, tol):
        return _jacobi_forward(ctx, inv_conv_solve_jacobi_guarded, x, w_eff,
                               groups, fast_iters, cap_iters, tol)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _jacobi_backward(ctx, inv_conv_solve_jacobi_guarded, g)


def inv_conv_solve_jacobi_implicit(x, w_eff, groups: int = 1,
                                   iters: int = 12, tol: float = 0.0):
    """:func:`inv_conv_solve_jacobi` with the implicit-function VJP (the
    JAX ``inv_conv_solve_jacobi_implicit``); ``tol > 0`` stops both the
    forward and the cotangent solve early."""
    return JacobiSolve.apply(x, w_eff, groups, iters, tol)


def inv_conv_solve_jacobi_guarded_implicit(x, w_eff, groups: int = 1,
                                           fast_iters: int = 12,
                                           cap_iters: int = 128,
                                           tol: float = 1e-3):
    """:func:`inv_conv_solve_jacobi_guarded` with the implicit-function
    VJP, whose cotangent solve is guarded too (the JAX
    ``inv_conv_solve_jacobi_guarded_implicit``): the solve that
    ``solver='auto'`` routes to."""
    return GuardedJacobiSolve.apply(x, w_eff, groups, fast_iters, cap_iters,
                                    tol)
