"""The monotone cubic B-spline bijection of [0, 1], and its inverse on the
hand-written kernel.

:func:`monotone_cubic_b_spline` is the port of
``inverse_flow_tpu/layers/splines.py:monotone_cubic_b_spline``, both
directions in plain torch; its inverse finds the bin and runs JAX's fixed
20 bisection steps and 5 Newton steps. :func:`bspline_inverse` runs that
inverse on a CUDA tensor as one launch of ``csrc/bspline_inverse.cu`` (each
coefficient set prepared once, the bin's cubic in power form solved by
bracketed Newton) and on a CPU tensor as :func:`bspline_inverse_reference`,
the plain version. It reads the raw coefficients in the caller's layout
(``LAYOUTS``): one set shared by every element, channel-major from a
coupling net, or the last dim; and it does the layers' elementwise work
around the spline: the affine map of an input interval onto [0, 1], the
map of [0, 1] back onto an output interval, and identity tails.
"""

from __future__ import annotations

import math

import torch

# csrc/bspline_inverse.cu:kMaxBins, the most bins the kernel takes
BSPLINE_MAX_BINS = 16
# csrc/bspline_inverse.cu:kMaxSteps, the cap on a lane's Newton steps
BSPLINE_MAX_STEPS = 16
# where the raw coefficients of y's elements are, for y of shape S:
# "shared" one set (K+3,) for all; "channels" (B, C*(K+3), *spatial) for y
# (B, C, *spatial), coefficient k of channel c at channel c*(K+3) + k, as a
# coupling net gives them; "last" (*S, K+3)
LAYOUTS = ("shared", "channels", "last")
# the kernels: "bracketed", csrc/bspline_inverse.cu:bspline_newton_*_kernel
# (every call); "first", bspline_inverse_first_kernel, the first design,
# forced by the timings only
BSPLINE_VARIANTS = ("bracketed", "first")


def clip01(x):
    """``x`` clipped to [0, 1] as ``jnp.clip``: an input at an end gets
    half the gradient (``torch.clamp`` would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def monotone_cubic_b_spline(x, unnormalized_coeffs, inverse=False,
                            min_step=1e-4):
    """A monotone cubic B-spline bijection of [0, 1], or its inverse.

    ``unnormalized_coeffs`` (..., K+3), broadcastable against
    ``x[..., None]``, are the raw control-point increments of K bins:
    softmax, floored at ``min_step``, and summed into increasing control
    points c_0 < ... < c_{K+2}. Returns (outputs, logabsdet) elementwise;
    with ``inverse`` the logdet of the inverse map."""
    kp3 = unnormalized_coeffs.shape[-1]
    k = kp3 - 3
    step = torch.softmax(unnormalized_coeffs, dim=-1)
    step = min_step + (1.0 - kp3 * min_step) * step
    c = torch.cumsum(step, dim=-1)
    # knot values v_j = (c_j + 4 c_{j+1} + c_{j+2}) / 6, j = 0..K
    v = (c[..., 0:k + 1] + 4.0 * c[..., 1:k + 2] + c[..., 2:k + 3]) / 6.0
    v0, scale = v[..., 0], v[..., -1] - v[..., 0]
    lead = x.shape
    v0 = v0.expand(lead) if v0.ndim else v0
    scale = scale.expand(lead) if scale.ndim else scale
    c_all = c.expand(lead + (kp3,))

    def eval_bin(i, t):
        """Spline value and d/dx at local parameter t of bin i, in
        normalized output coordinates."""
        idx = i[..., None] + torch.arange(4, device=i.device)
        c0, c1, c2, c3 = torch.gather(c_all, -1, idx).unbind(-1)
        omt = 1.0 - t
        f = (c0 * omt ** 3 + c1 * (3 * t ** 3 - 6 * t ** 2 + 4)
             + c2 * (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) + c3 * t ** 3) / 6.0
        # d f / d t, a quadratic B-spline in the increments (>= 0: monotone)
        dfdt = ((c1 - c0) * omt ** 2 + (c2 - c1) * (-2 * t ** 2 + 2 * t + 1)
                + (c3 - c2) * t ** 2) / 2.0
        return (f - v0) / scale, k * dfdt / scale

    if not inverse:
        u = clip01(x) * k
        i = torch.floor(u).clamp(0, k - 1)
        y, dydx = eval_bin(i.long(), u - i)
        return y, torch.log(dydx.clamp_min(1e-12))

    # the bin by the normalized, increasing knot values; then bisection
    # and a Newton polish on its local cubic
    y = clip01(x)
    vn = (v - v[..., :1]) / (v[..., -1:] - v[..., :1])
    i = ((y[..., None] >= vn).sum(-1) - 1).clamp(0, k - 1)
    lo, hi = torch.zeros_like(y), torch.ones_like(y)
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        below = eval_bin(i, mid)[0] < y
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    t = 0.5 * (lo + hi)
    for _ in range(5):
        f, dydx = eval_bin(i, t)
        t = (t - (f - y) * k / dydx.clamp_min(1e-9)).clamp(0.0, 1.0)
    _, dydx = eval_bin(i, t)
    return (i + t) / k, -torch.log(dydx.clamp_min(1e-12))


def _channels_kp3(y, coeffs):
    """K+3 of channel-major coefficients (B, C*(K+3), *spatial) for y
    (B, C, *spatial); raises where they do not fit."""
    b, c = y.shape[:2]
    if coeffs.ndim != y.ndim or coeffs.shape[0] != b or \
            coeffs.shape[2:] != y.shape[2:] or coeffs.shape[1] % c:
        raise ValueError(f"bspline_inverse: channel-major coefficients "
                         f"{tuple(coeffs.shape)} do not fit y "
                         f"{tuple(y.shape)}")
    return coeffs.shape[1] // c


def last_dim_coeffs(y, coeffs, layout):
    """``coeffs`` in ``layout`` as :func:`monotone_cubic_b_spline` takes
    them, broadcastable against ``y[..., None]``: the "channels" layout as
    a (B, C, *spatial, K+3) view, K+3 from the channel count of ``y``."""
    if layout != "channels":
        return coeffs
    kp3 = _channels_kp3(y, coeffs)
    spatial = tuple(range(3, coeffs.ndim + 1))
    return coeffs.reshape(y.shape[:2] + (kp3,) + coeffs.shape[2:]).permute(
        (0, 1) + spatial + (2,))


def bspline_inverse_reference(y, coeffs, layout, interval=None,
                              out_interval=None, tails=False, logdet=True):
    """The plain version: ``monotone_cubic_b_spline(u, ...,
    inverse=True)`` on the coefficients brought to the last dim, in the
    layers' own lines: ``u = clip01((y - lo) / (hi - lo))`` for
    ``interval`` (lo, hi), else ``u = y``; the output ``x * (out_hi -
    out_lo) + out_lo`` for ``out_interval``; with ``tails``, ``y`` and a
    log-det of 0 wherever ``!(lo < y < hi)``. Returns (x, log-det), the
    log-det None unless ``logdet``."""
    if tails and interval is None:
        raise ValueError("bspline_inverse: tails need an interval")
    u = y
    if interval is not None:
        lo, hi = interval
        u = clip01((y - lo) / (hi - lo))
    x, ld = monotone_cubic_b_spline(u, last_dim_coeffs(y, coeffs, layout),
                                    inverse=True)
    if out_interval is not None:
        out_lo, out_hi = out_interval
        x = x * (out_hi - out_lo) + out_lo
    if tails:
        inside = (y > lo) & (y < hi)
        x, ld = torch.where(inside, x, y), torch.where(inside, ld, 0.0)
    return x, (ld if logdet else None)


def _layout(y, coeffs, layout):
    """(bins, inner) of ``coeffs`` in ``layout`` for ``y``: ``inner`` as
    the kernel reads it, 0 for one shared set, the spatial size for
    channel-major, 1 for the last dim (csrc/bspline_inverse.cu). Raises
    where the coefficients do not fit y."""
    if layout == "shared":
        if coeffs.ndim != 1:
            raise ValueError(f"bspline_inverse: shared coefficients must be "
                             f"(K+3,), got {tuple(coeffs.shape)}")
        return coeffs.shape[0] - 3, 0
    if layout == "channels":
        return _channels_kp3(y, coeffs) - 3, math.prod(y.shape[2:])
    if layout == "last":
        if coeffs.shape[:-1] != y.shape:
            raise ValueError(f"bspline_inverse: last-dim coefficients "
                             f"{tuple(coeffs.shape)} do not fit y "
                             f"{tuple(y.shape)}")
        return coeffs.shape[-1] - 3, 1
    raise ValueError(f"bspline_inverse: unknown layout {layout!r}")


def _y_strides(y):
    """(y_row, y_stride) of ``y`` as the kernel reads it: element i at
    (i // y_row) * y_stride + i % y_row, for a contiguous ``y`` or one
    whose every dim but the first is contiguous (a channel slice of a
    contiguous tensor); None for any other."""
    if y.is_contiguous():
        return y.numel(), y.numel()
    if y.ndim > 1 and y[0].is_contiguous():
        return y[0].numel(), y.stride(0)
    return None


def bspline_inverse(y, coeffs, layout, *, interval=None, out_interval=None,
                    tails=False, logdet=True, steps=False, variant=None):
    """(x, logabsdet of the inverse) with ``monotone_cubic_b_spline(u,
    coeffs)[0] = y``, elementwise, the raw coefficients in ``layout``
    (``LAYOUTS``). ``interval`` (lo, hi) maps y onto [0, 1] (clipped; by
    default y is there already), ``out_interval`` maps x back from [0, 1],
    ``tails`` keeps y, with a log-det of 0, wherever ``!(lo < y < hi)``;
    the log-det is None unless ``logdet``
    (:func:`bspline_inverse_reference` says it in torch ops).

    CPU tensors take :func:`bspline_inverse_reference`; float32 CUDA
    tensors launch the kernel once, ``bspline_newton_*_kernel`` (or
    ``variant``, forced by the timings: ``"first"``, the bare spline only),
    counted in ``bspline_inverse.launches`` and ``.launches_by_variant``;
    anything else raises. With ``steps`` (CUDA only) a third result, each
    element's Newton steps (int32)."""
    if variant is not None and variant not in BSPLINE_VARIANTS:
        raise ValueError(f"bspline_inverse: unknown variant {variant!r}")
    if tails and interval is None:
        raise ValueError("bspline_inverse: tails need an interval")
    bins, inner = _layout(y, coeffs, layout)
    extras = dict(interval=interval, out_interval=out_interval, tails=tails,
                  logdet=logdet)
    if y.device.type == "cpu" and coeffs.device.type == "cpu":
        if steps:
            raise ValueError("bspline_inverse: the plain version counts no "
                             "steps")
        return bspline_inverse_reference(y, coeffs, layout, **extras)
    if y.device.type != "cuda" or coeffs.device != y.device:
        raise ValueError(f"bspline_inverse: unsupported devices {y.device}, "
                         f"{coeffs.device}")
    if y.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError("bspline_inverse: the kernel takes float32 only")
    if torch.is_grad_enabled() and (y.requires_grad or coeffs.requires_grad):
        raise NotImplementedError("bspline_inverse: the kernel has no "
                                  "autograd")
    if not 1 <= bins <= BSPLINE_MAX_BINS:
        raise ValueError(f"bspline_inverse: {bins} bins; the kernel takes "
                         f"1 to {BSPLINE_MAX_BINS}")
    variant = variant or "bracketed"
    if variant == "first" and (interval is not None or out_interval is not None
                               or tails or not logdet or steps):
        raise ValueError("bspline_inverse: the first design takes the bare "
                         "spline only")
    shape = y.shape
    x = torch.empty(shape, dtype=torch.float32, device=y.device)
    ld = torch.empty_like(x) if logdet else None
    n_steps = (torch.empty(shape, dtype=torch.int32, device=y.device)
               if steps else None)
    out = (x, ld) + ((n_steps,) if steps else ())
    if y.numel() == 0:
        return out
    strides = None if variant == "first" else _y_strides(y)
    if strides is None:
        y = y.contiguous()
        strides = y.numel(), y.numel()
    y_row, y_stride = strides
    coeffs = coeffs.contiguous()
    if inner == 1 and coeffs.data_ptr() % 16:
        coeffs = coeffs.clone()        # the kernel's 16-byte loads
    from ._build import bspline_inverse_lib

    lib = bspline_inverse_lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "first":
            err = lib.bspline_inverse_first_f32(
                y.data_ptr(), coeffs.data_ptr(), x.data_ptr(), ld.data_ptr(),
                y.numel(), bins, inner, stream)
        else:
            lo, hi = interval if interval is not None else (0.0, 1.0)
            out_lo, out_hi = (out_interval if out_interval is not None
                              else (0.0, 1.0))
            err = lib.bspline_inverse_f32(
                y.data_ptr(), coeffs.data_ptr(), x.data_ptr(),
                ld.data_ptr() if logdet else None,
                n_steps.data_ptr() if steps else None, y.numel(), bins,
                inner, y_row, y_stride, lo, hi, hi - lo, out_lo,
                out_hi - out_lo, int(tails), stream)
    if err != 0:
        raise RuntimeError(f"bspline_inverse: the {variant} kernel's launch "
                           f"failed with CUDA error {err}")
    bspline_inverse.launches += 1
    bspline_inverse.launches_by_variant[variant] += 1
    return out


def reset_bspline_launches():
    """Sets :func:`bspline_inverse`'s launch counts to 0."""
    bspline_inverse.launches = 0
    bspline_inverse.launches_by_variant = dict.fromkeys(BSPLINE_VARIANTS, 0)


reset_bspline_launches()
