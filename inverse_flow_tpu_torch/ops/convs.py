"""Convolution primitives in NCHW/OIHW layout: the conv and its two
gradients.

Port of ``inverse_flow_tpu/ops/convs.py`` (``conv2d``, ``conv2d_input_grad``,
``conv2d_weight_grad``). They are plain XLA convolutions in JAX, so here
they are cuDNN's (``F.conv2d`` and ``torch.nn.grad``): the input gradient
takes the input's shape, so a strided conv whose window leaves a remainder
gives it back as JAX's remainder padding does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def conv2d(x, w, stride=1, padding=0, dilation=1, groups=1):
    """``z = conv(x, w)``: x (B, Cin, H, W), w (Cout, Cin/groups, KH, KW),
    symmetric zero ``padding``."""
    return F.conv2d(x, w, None, _pair(stride), _pair(padding),
                    _pair(dilation), groups)


def conv2d_input_grad(g, w, x_shape, stride=1, padding=0, dilation=1,
                      groups=1):
    """The gradient of :func:`conv2d` with respect to its input, of shape
    ``x_shape``, given the cotangent ``g`` of its output."""
    return torch.nn.grad.conv2d_input(tuple(x_shape), w, g, _pair(stride),
                                      _pair(padding), _pair(dilation),
                                      groups)


def conv2d_weight_grad(g, x, w_shape, stride=1, padding=0, dilation=1,
                       groups=1):
    """The gradient of :func:`conv2d` with respect to its weight, of shape
    ``w_shape`` (Cout, Cin/groups, KH, KW): the correlation of the input
    ``x`` with the cotangent ``g``, the batch contracted."""
    return torch.nn.grad.conv2d_weight(x, tuple(w_shape), g, _pair(stride),
                                       _pair(padding), _pair(dilation),
                                       groups)
