"""Dense conv-as-matrix operators for the exact log-determinants and the
exact inverses.

Port of ``inverse_flow_tpu/ops/toeplitz.py``. The operator is built by
pushing an identity basis through :func:`~.convs.conv2d`, so it agrees
with the conv by construction; its slogdet and solve are
``torch.linalg``'s (cuSOLVER on the card), as they were ``jnp.linalg`` in
JAX. Eval and sampling paths only: the operator is (CHW)^2 floats.
"""

from __future__ import annotations

import torch

from .convs import conv2d


def dense_conv_operator(w, in_shape, stride=1, padding=0):
    """``T`` (out_dim, in_dim) with ``z.flatten() = T @ x.flatten()`` for
    ``z = conv2d(x, w)``; ``in_shape`` is (C, H, W) without the batch."""
    c, h, width = in_shape
    dim = c * h * width
    basis = torch.eye(dim, dtype=torch.float32, device=w.device).reshape(
        dim, c, h, width)
    cols = conv2d(basis, w, stride=stride, padding=padding)
    return cols.reshape(dim, -1).T


def conv_logdet(w, in_shape, stride=1, padding=0):
    """log |det T|: the conv's exact log-determinant for one sample."""
    return torch.linalg.slogdet(
        dense_conv_operator(w, in_shape, stride, padding))[1]


def conv_exact_inverse(z, w, in_shape, stride=1, padding=0):
    """``x = T^{-1} z`` by a dense solve; ``in_shape`` is x's (C, H, W)."""
    t = dense_conv_operator(w, in_shape, stride, padding)
    b = z.shape[0]
    x = torch.linalg.solve(t, z.reshape(b, -1).T).T
    return x.reshape((b,) + tuple(in_shape))
