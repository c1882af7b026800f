"""Deterministic synthetic image data (smoke runs and the MNIST fallback).

Port of ``inverse_flow_tpu/data/synthetic.py``: smooth random
low-frequency fields quantized to 0-255, the same arrays for the same
seed.
"""

from __future__ import annotations

import numpy as np

from .loader import ArrayLoader


def smooth_images(n, shape, seed=0):
    """(n, C, H, W) uint8-valued float32 images with spatial structure."""
    c, h, w = shape
    rng = np.random.RandomState(seed)
    k = 4                                   # low-frequency basis mixing
    fy = rng.randn(n, c, k, 1, 1).astype(np.float32)
    fx = rng.randn(n, c, k, 1, 1).astype(np.float32)
    ph = rng.rand(n, c, k, 1, 1).astype(np.float32) * 2 * np.pi
    ys = np.linspace(0, 2 * np.pi, h, dtype=np.float32).reshape(1, 1, 1, h, 1)
    xs = np.linspace(0, 2 * np.pi, w, dtype=np.float32).reshape(1, 1, 1, 1, w)
    field = np.sum(np.sin(fy * ys + fx * xs + ph), axis=2)
    field = field / (np.abs(field).max() + 1e-6)
    img = (field * 0.5 + 0.5) * 255.0
    img += rng.rand(*img.shape).astype(np.float32)  # sub-quantization jitter
    return np.floor(np.clip(img, 0, 255)).astype(np.float32)


def load_data(shape=(1, 28, 28), n_train=2000, n_val=500, n_test=500,
              batch_size=100, seed=0):
    train = smooth_images(n_train, shape, seed=seed)
    val = smooth_images(n_val, shape, seed=seed + 1)
    test = smooth_images(n_test, shape, seed=seed + 2)
    return (ArrayLoader(train, batch_size, shuffle=True, seed=seed),
            ArrayLoader(val, batch_size, drop_last=False),
            ArrayLoader(test, batch_size, drop_last=False))
