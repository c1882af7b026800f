"""The smooth leaky ReLU and the smooth tanh, and their inverses on the
hand-written kernels.

``slr(x, alpha) = alpha*x + (1-alpha)*softplus(x)``, softplus as JAX's
``logaddexp(x, 0)``, and ``slr_prime = alpha + (1-alpha)*sigmoid(x)``;
``smooth_tanh(x, alpha, beta) = tanh(alpha*x) + beta*x`` and
``smooth_tanh_prime = beta + alpha/cosh(alpha*x)^2``. Each inverse is JAX's
fixed Newton-Raphson (``inverse_flow_tpu/layers/activations.py:38-46``):
100 steps from x = y, f' floored at 1e-2. :func:`slr_inverse` and
:func:`smooth_tanh_inverse` run it on a CUDA tensor as one launch of a
kernel of ``csrc/slr_inverse.cu``, all the steps in registers, and on a CPU
tensor as :func:`slr_inverse_reference` /
:func:`smooth_tanh_inverse_reference`, the same loop in plain torch.

The SLR kernel stops a warp once a step has moved every lane's x by at
most ``SLR_EXIT_TOL * max(1, |x|)``, where Newton has converged to within
float32's rounding of the residual (the reference loop's own iterate cycles
between floats a few ulp apart for some y, so a bitwise fixed point is not
always reached). The smooth tanh's kernel stops each lane on its own, at
that step test or once the step's residual ``|f(x) - y|`` is at most
``SLR_EXIT_TOL * max(1, |y|)``, and the warp when every lane has stopped:
its iterate can cycle wider than the step test where f' is near beta, but
not with a residual above float32's rounding. :func:`slr_inverse_steps` and
:func:`smooth_tanh_inverse_steps` count, per element, the steps the
reference loop needs to settle, bit for bit or by those tests.
"""

from __future__ import annotations

import torch

NEWTON_ITERS = 100
FPRIME_FLOOR = 1e-2
# csrc/slr_inverse.cu:kExitTol, 2^-22: 2 ulp of 1
SLR_EXIT_TOL = 2.0 ** -22


def slr(x, alpha):
    return alpha * x + (1 - alpha) * torch.logaddexp(x, torch.zeros_like(x))


def slr_prime(x, alpha):
    return alpha + (1 - alpha) * torch.sigmoid(x)


def _newton_step(x, y, alpha):
    fprime = torch.clamp(slr_prime(x, alpha), min=FPRIME_FLOOR)
    return x - (slr(x, alpha) - y) / fprime


def slr_inverse_reference(y, alpha, iters=NEWTON_ITERS):
    """The Newton loop in plain torch, step for step JAX's."""
    x = y
    for _ in range(iters):
        x = _newton_step(x, y, alpha)
    return x


def smooth_tanh(x, alpha, beta):
    return torch.tanh(alpha * x) + beta * x


def smooth_tanh_prime(x, alpha, beta):
    return beta + alpha / torch.cosh(alpha * x) ** 2


def _tanh_newton_step(x, y, alpha, beta):
    fprime = torch.clamp(smooth_tanh_prime(x, alpha, beta), min=FPRIME_FLOOR)
    return x - (smooth_tanh(x, alpha, beta) - y) / fprime


def smooth_tanh_inverse_reference(y, alpha, beta, iters=NEWTON_ITERS):
    """The Newton loop in plain torch, step for step JAX's."""
    x = y
    for _ in range(iters):
        x = _tanh_newton_step(x, y, alpha, beta)
    return x


def smooth_tanh_inverse_history(y, alpha, beta, iters=NEWTON_ITERS):
    """The iterates of :func:`smooth_tanh_inverse_reference`, stacked:
    ``(iters, *y.shape)``, the last its result."""
    x, hist = y, []
    for _ in range(iters):
        x = _tanh_newton_step(x, y, alpha, beta)
        hist.append(x)
    return torch.stack(hist)


def smooth_tanh_inverse_limit(y, hist, alpha, beta, exit_tol=SLR_EXIT_TOL):
    """Per element of ``y``, how far another float32 Newton loop for the
    same inverse may land from the plain loop's result ``hist[-1]``
    (``hist`` from :func:`smooth_tanh_inverse_history`): twice the other
    loop's exit test, ``exit_tol * max(1, |x|)`` (0 for a loop that runs
    every step, as JAX's does); the width of the plain loop's own cycle
    after step 20; and the residual's rounding where both settle on
    different floats of a flat residual, 4 ulp of ``max(1, |y|)`` over
    f'(x)."""
    ref = hist[-1]
    width = hist[20:].max(0).values - hist[20:].min(0).values
    return (2 * exit_tol * ref.abs().clamp(min=1.0) + width
            + 4 * 2.0 ** -23 * y.abs().clamp(min=1.0)
            / smooth_tanh_prime(ref, alpha, beta))


def slr_inverse_steps(y, alpha, iters=NEWTON_ITERS, tol=0.0):
    """Per element of ``y``, the Newton steps :func:`slr_inverse_reference`
    runs from x = y until a step moves x by at most ``tol * max(1, |x|)``
    (int32, at most ``iters``). ``tol`` 0: until a step leaves x unchanged
    bit for bit, after which it never changes again, so the loop's x after
    that many steps is its ``iters``-step x. ``tol`` ``SLR_EXIT_TOL``: the
    kernel's exit test, the work a loop that stops there does on these
    inputs."""
    return _newton_steps(lambda x: _newton_step(x, y, alpha), y, iters, tol)


# the exit rules of smooth_tanh_inverse_steps: "step", a step moved x by
# at most tol * max(1, |x|) (the first design's test); "residual", that or
# |f(x) - y| <= tol * max(1, |y|) at the step's x (the kernel's)
TANH_EXIT_RULES = ("step", "residual")


def smooth_tanh_inverse_steps(y, alpha, beta, iters=NEWTON_ITERS, tol=0.0,
                              rule="step"):
    """:func:`slr_inverse_steps` for :func:`smooth_tanh_inverse_reference`,
    by the exit ``rule`` (``TANH_EXIT_RULES``). ``rule`` ``"residual"``
    with ``tol`` ``SLR_EXIT_TOL`` is the kernel's exit: the loop's x after
    that many steps (``smooth_tanh_inverse_history(...)[steps - 1]``) is
    the x a lane keeps."""
    if rule not in TANH_EXIT_RULES:
        raise ValueError(f"unknown exit rule {rule!r}")
    if rule == "residual" and not tol:
        raise ValueError("the residual rule needs a tolerance")
    residual = None
    if rule == "residual":
        def residual(x):
            return smooth_tanh(x, alpha, beta) - y
    return _newton_steps(lambda x: _tanh_newton_step(x, y, alpha, beta), y,
                         iters, tol, residual)


def _newton_steps(step, y, iters, tol, residual=None):
    x = y
    steps = torch.full(y.shape, iters, dtype=torch.int32, device=y.device)
    done = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    for k in range(1, iters + 1):
        nxt = step(x)
        if tol:
            fixed = (nxt - x).abs() <= tol * x.abs().clamp(min=1.0)
        else:
            fixed = nxt.view(torch.int32) == x.view(torch.int32)
        if residual is not None:
            fixed |= residual(x).abs() <= tol * y.abs().clamp(min=1.0)
        fixed &= ~done
        steps[fixed] = k
        done |= fixed
        x = nxt
    return steps


# the kernels of csrc/slr_inverse.cu: "early_exit" stops a warp once its
# lanes have settled (the one every call takes), "fixed" is the first
# design, all `iters` steps, kept as a forced variant for the timings
SLR_VARIANTS = ("early_exit", "fixed")
_SLR_LAUNCHERS = {"early_exit": "slr_inverse_f32",
                  "fixed": "slr_inverse_fixed_f32"}


def _newton_launch(name, launcher, y, *params):
    """x = the kernel ``launcher``'s inverse of the float32 CUDA tensor
    ``y`` (``params`` after the element count, ``iters`` last); raises on
    what the kernel does not take."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 only")
    if torch.is_grad_enabled() and y.requires_grad:
        raise NotImplementedError(f"{name}: the kernel has no autograd")
    y = y.contiguous()
    x = torch.empty_like(y)
    if y.numel() == 0:
        return x
    from ._build import slr_inverse_lib

    with torch.cuda.device(y.device):
        err = getattr(slr_inverse_lib(), launcher)(
            y.data_ptr(), x.data_ptr(), y.numel(), *params,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {launcher} launch failed with CUDA "
                           f"error {err}")
    return x


def slr_inverse(y, alpha, iters=NEWTON_ITERS, variant=None):
    """x with ``slr(x, alpha) = y``, by ``iters`` Newton steps. CPU tensors
    take :func:`slr_inverse_reference`; a float32 CUDA tensor launches
    ``slr_inverse_kernel`` (or ``variant``, forced by the timings),
    counted in ``slr_inverse.launches`` and ``.launches_by_variant``."""
    if variant is not None and variant not in SLR_VARIANTS:
        raise ValueError(f"slr_inverse: unknown variant {variant!r}")
    if y.device.type == "cpu":
        return slr_inverse_reference(y, alpha, iters)
    variant = variant or "early_exit"
    x = _newton_launch("slr_inverse", _SLR_LAUNCHERS[variant], y,
                       float(alpha), int(iters))
    if y.numel():
        slr_inverse.launches += 1
        slr_inverse.launches_by_variant[variant] += 1
    return x


def reset_slr_launches():
    """Sets :func:`slr_inverse`'s launch counts to 0."""
    slr_inverse.launches = 0
    slr_inverse.launches_by_variant = dict.fromkeys(SLR_VARIANTS, 0)


# the smooth tanh's kernels: "lane_exit" stops each lane at the step or
# residual test (every call), "step_exit" is the first design, the SLR
# kernel's warp exit, kept as a forced variant for the timings
TANH_VARIANTS = ("lane_exit", "step_exit")
_TANH_LAUNCHERS = {"lane_exit": "smooth_tanh_inverse_f32",
                   "step_exit": "smooth_tanh_inverse_step_exit_f32"}


def smooth_tanh_inverse(y, alpha, beta, iters=NEWTON_ITERS, variant=None):
    """x with ``smooth_tanh(x, alpha, beta) = y``, by at most ``iters``
    Newton steps. CPU tensors take :func:`smooth_tanh_inverse_reference`;
    a float32 CUDA tensor launches ``newton_lane_exit_kernel<TanhStep>``
    (or ``variant``, forced by the timings), counted in
    ``smooth_tanh_inverse.launches`` and ``.launches_by_variant``."""
    if variant is not None and variant not in TANH_VARIANTS:
        raise ValueError(f"smooth_tanh_inverse: unknown variant {variant!r}")
    if y.device.type == "cpu":
        return smooth_tanh_inverse_reference(y, alpha, beta, iters)
    variant = variant or "lane_exit"
    x = _newton_launch("smooth_tanh_inverse", _TANH_LAUNCHERS[variant], y,
                       float(alpha), float(beta), int(iters))
    if y.numel():
        smooth_tanh_inverse.launches += 1
        smooth_tanh_inverse.launches_by_variant[variant] += 1
    return x


def reset_smooth_tanh_launches():
    """Sets :func:`smooth_tanh_inverse`'s launch counts to 0."""
    smooth_tanh_inverse.launches = 0
    smooth_tanh_inverse.launches_by_variant = dict.fromkeys(TANH_VARIANTS, 0)


reset_slr_launches()
reset_smooth_tanh_launches()
