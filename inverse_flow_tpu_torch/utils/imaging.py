"""Image-grid saver for sample and reconstruction dumps.

Numpy-only copy of ``inverse_flow_tpu/utils/imaging.py`` (``make_grid``,
``write_png``, ``save_image_grid``, ``filter_heatmap_grid``;
``tests/test_torch_sample.py`` and ``tests/test_torch_timescaling.py``
hold it to the JAX one byte for byte). PNG is written by the pure-python encoder
below: no PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def make_grid(x, nrow=10, padding=2):
    """x: (N, C, H, W) floats in [0,1] -> (H', W', 3) uint8 grid."""
    x = np.asarray(x, np.float32)
    n, c, h, w = x.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.ones((c, nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        top = r * (h + padding) + padding
        left = col * (w + padding) + padding
        grid[:, top:top + h, left:left + w] = x[i]
    grid = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    if c == 1:
        grid = np.repeat(grid, 3, axis=0)
    return np.transpose(grid[:3], (1, 2, 0))


def write_png(path, rgb):
    """Write (H, W, 3) uint8 as PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        payload = tag + data
        return (struct.pack(">I", len(data)) + payload
                + struct.pack(">I", zlib.crc32(payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_image_grid(x, path, nrow=10, padding=2):
    write_png(path, make_grid(x, nrow=nrow, padding=padding))


def filter_heatmap_grid(w):
    """A (C_out, C_in, KH, KW) conv kernel as one heatmap grid image: C_out
    rows of C_in KHxKW tiles, each kernel scaled to [0, 1] on its own."""
    w = np.asarray(w, np.float32)
    co, ci, kh, kw = w.shape
    lo = w.min(axis=(2, 3), keepdims=True)
    hi = w.max(axis=(2, 3), keepdims=True)
    norm = (w - lo) / np.maximum(hi - lo, 1e-12)
    tiles = norm.reshape(co * ci, 1, kh, kw)
    return make_grid(np.repeat(tiles, 3, axis=1), nrow=ci, padding=1)
