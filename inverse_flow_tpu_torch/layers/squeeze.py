"""Squeeze (2x2 space-to-depth) and UnSqueeze (its inverse), volume
preserving.

Port of ``inverse_flow_tpu/layers/squeeze.py`` with the same element order.
"""

from __future__ import annotations

from .base import FlowLayer, zeros_ldj


def space_to_depth(x):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)


def depth_to_space(x):
    b, c, h, w = x.shape
    x = x.reshape(b, c // 4, 2, 2, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, c // 4, h * 2, w * 2)


class Squeeze(FlowLayer):
    def out_shape(self, shape):
        c, h, w = shape
        return (c * 4, h // 2, w // 2)

    def forward_with(self, p, x, generator=None):
        return space_to_depth(x), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        return depth_to_space(z)


class UnSqueeze(FlowLayer):
    def out_shape(self, shape):
        c, h, w = shape
        return (c // 4, h * 2, w * 2)

    def forward_with(self, p, x, generator=None):
        return depth_to_space(x), zeros_ldj(x)

    def inverse_with(self, p, z, generator=None):
        return space_to_depth(z)
