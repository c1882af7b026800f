"""The benchmark's inputs, made from ``--seed``: sub-seeds, and smooth
synthetic images on the device.

The images follow the program's synthetic-data recipe (smooth random
low-frequency fields quantized to 0-255, a copy frozen here so that a
change to the program cannot move the benchmark's data), drawn with a
``torch.Generator`` on the card instead of numpy on the host.
"""

from __future__ import annotations

import hashlib
import math


def sub_seed(seed, tag):
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, tag, device):
    import torch

    return torch.Generator(device).manual_seed(sub_seed(seed, tag))


def smooth_images(n, shape, gen, device):
    """(n, C, H, W) float32 images with values 0..255: a sum of 4 random
    sinusoids a channel, scaled by the batch's largest magnitude, plus
    sub-quantization jitter, floored."""
    import torch

    c, h, w = shape
    k = 4
    fy = torch.randn((n, c, k, 1, 1), generator=gen, device=device)
    fx = torch.randn((n, c, k, 1, 1), generator=gen, device=device)
    ph = torch.rand((n, c, k, 1, 1), generator=gen, device=device) * 2 * math.pi
    ys = torch.linspace(0, 2 * math.pi, h, device=device).reshape(1, 1, 1, h, 1)
    xs = torch.linspace(0, 2 * math.pi, w, device=device).reshape(1, 1, 1, 1, w)
    field = torch.sin(fy * ys + fx * xs + ph).sum(2)
    field = field / (field.abs().max() + 1e-6)
    img = (field * 0.5 + 0.5) * 255.0
    img = img + torch.rand(img.shape, generator=gen, device=device)
    return torch.floor(img.clamp(0, 255))
