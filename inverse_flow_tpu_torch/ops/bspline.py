"""The monotone cubic B-spline bijection of [0, 1], and its inverse on the
hand-written kernel.

:func:`monotone_cubic_b_spline` is the port of
``inverse_flow_tpu/layers/splines.py:monotone_cubic_b_spline``, both
directions in plain torch; its inverse finds the bin and runs JAX's fixed
20 bisection steps and 5 Newton steps. :func:`bspline_inverse` runs that
inverse on a CUDA tensor as one launch of ``csrc/bspline_inverse.cu``
(softmax, knots, bin, bisection and Newton in registers) and on a CPU
tensor as :func:`bspline_inverse_reference`, the plain version. It reads
the raw coefficients in the caller's layout (``LAYOUTS``): one set shared
by every element, channel-major from a coupling net, or the last dim.
"""

from __future__ import annotations

import math

import torch

# csrc/bspline_inverse.cu:kMaxBins, the most bins the kernel takes
BSPLINE_MAX_BINS = 16
# where the raw coefficients of y's elements are, for y of shape S:
# "shared" one set (K+3,) for all; "channels" (B, C*(K+3), *spatial) for y
# (B, C, *spatial), coefficient k of channel c at channel c*(K+3) + k, as a
# coupling net gives them; "last" (*S, K+3)
LAYOUTS = ("shared", "channels", "last")


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


def last_dim_coeffs(y, coeffs, layout):
    """``coeffs`` in ``layout`` as :func:`monotone_cubic_b_spline` takes
    them, broadcastable against ``y[..., None]``: the "channels" layout as
    a (B, C, *spatial, K+3) view, K+3 from the channel count of ``y``."""
    if layout != "channels":
        return coeffs
    b, c = y.shape[:2]
    if coeffs.ndim != y.ndim or coeffs.shape[0] != b or \
            coeffs.shape[2:] != y.shape[2:] or coeffs.shape[1] % c:
        raise ValueError(f"bspline_inverse: channel-major coefficients "
                         f"{tuple(coeffs.shape)} do not fit y "
                         f"{tuple(y.shape)}")
    kp3 = coeffs.shape[1] // c
    spatial = tuple(range(3, coeffs.ndim + 1))
    return coeffs.reshape((b, c, kp3) + coeffs.shape[2:]).permute(
        (0, 1) + spatial + (2,))


def bspline_inverse_reference(y, coeffs, layout):
    """The plain version: ``monotone_cubic_b_spline(y, ...,
    inverse=True)`` on the coefficients brought to the last dim."""
    return monotone_cubic_b_spline(y, last_dim_coeffs(y, coeffs, layout),
                                   inverse=True)


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
        return (last_dim_coeffs(y, coeffs, layout).shape[-1] - 3,
                math.prod(y.shape[2:]))
    if layout == "last":
        if coeffs.shape[:-1] != y.shape:
            raise ValueError(f"bspline_inverse: last-dim coefficients "
                             f"{tuple(coeffs.shape)} do not fit y "
                             f"{tuple(y.shape)}")
        return coeffs.shape[-1] - 3, 1
    raise ValueError(f"bspline_inverse: unknown layout {layout!r}")


def bspline_inverse(y, coeffs, layout):
    """(x, logabsdet of the inverse) with ``monotone_cubic_b_spline(x,
    coeffs)[0] = y``, elementwise over ``y`` in [0, 1] (clipped), the raw
    coefficients in ``layout`` (``LAYOUTS``). CPU tensors take
    :func:`bspline_inverse_reference`; float32 CUDA tensors launch
    ``bspline_inverse_kernel`` once, counted in
    ``bspline_inverse.launches``; anything else raises."""
    bins, inner = _layout(y, coeffs, layout)
    if y.device.type == "cpu" and coeffs.device.type == "cpu":
        return bspline_inverse_reference(y, coeffs, layout)
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
    y, coeffs = y.contiguous(), coeffs.contiguous()
    x, logdet = torch.empty_like(y), torch.empty_like(y)
    if y.numel() == 0:
        return x, logdet
    from ._build import bspline_inverse_lib

    with torch.cuda.device(y.device):
        err = bspline_inverse_lib().bspline_inverse_f32(
            y.data_ptr(), coeffs.data_ptr(), x.data_ptr(), logdet.data_ptr(),
            y.numel(), bins, inner, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bspline_inverse: bspline_inverse_f32 launch "
                           f"failed with CUDA error {err}")
    bspline_inverse.launches += 1
    return x, logdet


def reset_bspline_launches():
    """Sets :func:`bspline_inverse`'s launch count to 0."""
    bspline_inverse.launches = 0


reset_bspline_launches()
