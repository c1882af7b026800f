"""2-D toy densities for flow sanity experiments.

Numpy copy of ``inverse_flow_tpu/data/toy.py`` (the reference's FFJORD-
style family, ``inf/datasets/toy_density_data.py:15-110``: 8gaussians,
moons, pinwheel, spirals, checkerboard, rings, swissroll, circles, sine,
...): the same draws from the same seed. ``sample_toy`` returns (N, 2)
float32 samples; ``load_data`` the three loaders.
"""

from __future__ import annotations

import numpy as np


def sample_toy(name, n, seed=0):
    rng = np.random.RandomState(seed)
    if name == "8gaussians":
        scale = 4.0
        sq2 = 1.0 / np.sqrt(2)
        centers = scale * np.array(
            [(1, 0), (-1, 0), (0, 1), (0, -1),
             (sq2, sq2), (sq2, -sq2), (-sq2, sq2), (-sq2, -sq2)], np.float32)
        x = rng.randn(n, 2).astype(np.float32) * 0.5
        x += centers[rng.randint(0, 8, n)]
        return x / 1.414
    if name == "2spirals":
        t = np.sqrt(rng.rand(n)) * 540 * (2 * np.pi) / 360
        sgn = np.where(rng.rand(n) < 0.5, 1.0, -1.0)
        dx = -np.cos(t) * t / 3
        dy = np.sin(t) * t / 3
        x = np.stack([sgn * dx, sgn * dy], axis=1)
        return (x + rng.randn(n, 2) * 0.1).astype(np.float32)
    if name == "checkerboard":
        x1 = rng.rand(n) * 4 - 2
        x2_ = rng.rand(n) - rng.randint(0, 2, n) * 2
        x2 = x2_ + np.floor(x1) % 2
        return np.stack([x1, x2], axis=1).astype(np.float32) * 2
    if name == "rings":
        radii = np.array([0.25, 0.5, 0.75, 1.0]) * 4
        r = radii[rng.randint(0, 4, n)]
        t = rng.rand(n) * 2 * np.pi
        x = np.stack([r * np.cos(t), r * np.sin(t)], axis=1)
        return (x + rng.randn(n, 2) * 0.08).astype(np.float32)
    if name == "moons":
        t = np.pi * rng.rand(n)
        top = rng.rand(n) < 0.5
        x = np.where(top[:, None],
                     np.stack([np.cos(t), np.sin(t)], 1),
                     np.stack([1 - np.cos(t), -np.sin(t) + 0.5], 1))
        x = (x - np.array([0.5, 0.25])) * 2
        return (x + rng.randn(n, 2) * 0.1).astype(np.float32)
    if name == "swissroll":
        t = 1.5 * np.pi * (1 + 2 * rng.rand(n))
        x = np.stack([t * np.cos(t), t * np.sin(t)], 1) / 5.0
        return (x + rng.randn(n, 2) * 0.1).astype(np.float32)
    if name == "circles":
        t = 2 * np.pi * rng.rand(n)
        r = np.where(rng.rand(n) < 0.5, 1.0, 0.5) * 3
        x = np.stack([r * np.cos(t), r * np.sin(t)], 1)
        return (x + rng.randn(n, 2) * 0.08).astype(np.float32)
    if name == "sine":
        x1 = rng.rand(n) * 8 - 4
        x2 = np.sin(2 * x1) + rng.randn(n) * 0.2
        return np.stack([x1, x2], axis=1).astype(np.float32)
    if name == "1gaussian":
        return rng.randn(n, 2).astype(np.float32)
    if name in ("trimodal", "trimodal2"):
        centers = np.array([(0, 0), (5, 5), (5, -5)], np.float32)
        stds = (np.array([1.0, 0.5, 0.5], np.float32)
                if name == "trimodal"
                else np.array([0.5, 0.5, 0.5], np.float32))
        k = rng.randint(0, 3, n)
        x = rng.randn(n, 2).astype(np.float32) * stds[k, None] + centers[k]
        return x
    if name == "smile":
        scale, sq2 = 4.0, 1.0 / np.sqrt(2)
        s3 = np.sqrt(3) / 2
        centers = np.array(
            [(0.5, -0.8660254), (-0.5, -0.8660254), (0.0, 0.0),   # mouth/nose
             (0.0, 1.0), (sq2, sq2), (-sq2, sq2),                  # brow
             (0.5, s3), (0.25881905, 0.96592583),
             (-0.5, s3), (-0.25881905, 0.96592583)],
            np.float32) * scale
        weights = np.array([1 / 6] * 3 + [1 / 14] * 7, np.float32)
        k = rng.choice(len(centers), size=n, p=weights / weights.sum())
        return (rng.randn(n, 2).astype(np.float32) * 0.5
                + centers[k]).astype(np.float32)
    if name == "pinwheel":
        rad_std, tan_std, n_cls, rate = 0.3, 0.1, 5, 0.25
        rads = np.linspace(0, 2 * np.pi, n_cls, endpoint=False)
        feats = rng.randn(n, 2) * np.array([rad_std, tan_std])
        feats[:, 0] += 1.0
        labels = rng.randint(0, n_cls, n)
        angles = rads[labels] + rate * np.exp(feats[:, 0])
        rot = np.stack([np.cos(angles), -np.sin(angles),
                        np.sin(angles), np.cos(angles)], axis=1)
        rot = rot.reshape(n, 2, 2)
        return 2 * np.einsum("ni,nij->nj", feats, rot).astype(np.float32)
    raise ValueError(f"unknown toy density: {name}")


def load_data(name="8gaussians", n_train=50_000, n_val=5_000, n_test=5_000,
              batch_size=256, seed=0, **kwargs):
    """(train, val, test) loaders of ``name``'s samples, from seeds
    ``seed``, ``seed + 1`` and ``seed + 2``; train shuffles."""
    from .loader import ArrayLoader
    return (ArrayLoader(sample_toy(name, n_train, seed), batch_size,
                        shuffle=True, seed=seed),
            ArrayLoader(sample_toy(name, n_val, seed + 1), batch_size,
                        drop_last=False),
            ArrayLoader(sample_toy(name, n_test, seed + 2), batch_size,
                        drop_last=False))
