"""Galaxy-mergers dataset prep and loader.

Numpy copy of ``inverse_flow_tpu/data/galaxy.py`` (the reference's
``inf/experiments/prepare_galaxy_data.py``): read the galaxy_mergers jpeg
folders (training/validation/test), resize to a fixed resolution with
PIL's anti-aliased resize, keep uint8, and pickle the three arrays; the
loader feeds raw 0..255 values in CHW. PIL is imported only when images
are read, and its absence raises there. No synthetic fallback, as in JAX.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .loader import ArrayLoader


def _read_images(path, resolution=(64, 64)):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("galaxy prep needs PIL") from e
    xs = []
    for name in sorted(os.listdir(path)):
        if name.startswith(".") or not name.endswith((".jpeg", ".jpg")):
            continue
        with Image.open(os.path.join(path, name)) as im:
            im = im.convert("RGB").resize(resolution[::-1], Image.LANCZOS)
            xs.append(np.asarray(im, np.uint8)[None])
    if not xs:
        raise FileNotFoundError(f"no jpeg images under {path}")
    return np.concatenate(xs, axis=0)


def prepare(root="galaxy_mergers/noninteracting", resolution=(64, 64),
            out_path="galaxy64.pkl"):
    """Build the pickled (train, val, test) uint8 arrays (NHWC)."""
    splits = {s: _read_images(os.path.join(root, s), resolution)
              for s in ("training", "validation", "test")}
    with open(out_path, "wb") as f:
        pickle.dump((splits["training"], splits["validation"],
                     splits["test"]), f)
    return out_path


def load_data(batch_size=100, path="galaxy64.pkl", seed=0, **_):
    """(train, val, test) loaders of CHW float batches in [0, 256)."""
    with open(path, "rb") as f:
        train, val, test = pickle.load(f)

    def to_nchw(a):
        return np.transpose(a, (0, 3, 1, 2)).astype(np.float32)

    return (ArrayLoader(to_nchw(train), batch_size, shuffle=True, seed=seed),
            ArrayLoader(to_nchw(val), batch_size, drop_last=False),
            ArrayLoader(to_nchw(test), batch_size, drop_last=False))
