"""The smooth leaky ReLU and its inverse on the hand-written kernel.

``slr(x, alpha) = alpha*x + (1-alpha)*softplus(x)``, softplus as JAX's
``logaddexp(x, 0)``, and ``slr_prime = alpha + (1-alpha)*sigmoid(x)``. Its
inverse is JAX's fixed Newton-Raphson
(``inverse_flow_tpu/layers/activations.py:38-46``): 100 steps from x = y,
f' floored at 1e-2. :func:`slr_inverse` runs it on a CUDA tensor as one
launch of ``csrc/slr_inverse.cu``, all the steps in registers, and on a CPU
tensor as :func:`slr_inverse_reference`, the same loop in plain torch.
"""

from __future__ import annotations

import torch

NEWTON_ITERS = 100
FPRIME_FLOOR = 1e-2


def slr(x, alpha):
    return alpha * x + (1 - alpha) * torch.logaddexp(x, torch.zeros_like(x))


def slr_prime(x, alpha):
    return alpha + (1 - alpha) * torch.sigmoid(x)


def slr_inverse_reference(y, alpha, iters=NEWTON_ITERS):
    """The Newton loop in plain torch, step for step JAX's."""
    x = y
    for _ in range(iters):
        fprime = torch.clamp(slr_prime(x, alpha), min=FPRIME_FLOOR)
        x = x - (slr(x, alpha) - y) / fprime
    return x


def slr_inverse(y, alpha, iters=NEWTON_ITERS):
    """x with ``slr(x, alpha) = y``, by ``iters`` Newton steps. CPU tensors
    take :func:`slr_inverse_reference`; a float32 CUDA tensor launches
    ``slr_inverse_kernel``, counted in ``slr_inverse.launches``."""
    if y.device.type == "cpu":
        return slr_inverse_reference(y, alpha, iters)
    if y.device.type != "cuda":
        raise ValueError(f"slr_inverse: unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError("slr_inverse: the kernel takes float32 only")
    if torch.is_grad_enabled() and y.requires_grad:
        raise NotImplementedError("slr_inverse: the kernel has no autograd")
    y = y.contiguous()
    x = torch.empty_like(y)
    if y.numel() == 0:
        return x
    from ._build import slr_inverse_lib

    with torch.cuda.device(y.device):
        err = slr_inverse_lib().slr_inverse_f32(
            y.data_ptr(), x.data_ptr(), y.numel(), float(alpha), int(iters),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"slr_inverse: kernel launch failed with CUDA "
                           f"error {err}")
    slr_inverse.launches += 1
    return x


slr_inverse.launches = 0
