"""Downsampled-ImageNet loaders (32x32 and 64x64).

Port of ``inverse_flow_tpu/data/imagenet.py``, numpy only. Reads the
standard npz/npy shards from ``$IFT_DATA_DIR/imagenet{32,64}`` (files
matching ``train_data*`` and ``val_data*``, rows of 3*size*size values
reshaped to (3, size, size)) and splits a random 20k validation set off
the training images. If the shards are absent it falls back, with a
warning, to the deterministic synthetic images the JAX package uses.
"""

from __future__ import annotations

import glob
import os
import warnings

import numpy as np

from .loader import ArrayLoader


def _load_shards(pattern, size):
    parts = []
    for f in sorted(glob.glob(pattern)):
        if f.endswith(".npz"):
            with np.load(f) as z:
                key = "data" if "data" in z else list(z.keys())[0]
                parts.append(z[key])
        else:
            parts.append(np.load(f))
    if not parts:
        return None
    data = np.concatenate(parts)
    if data.ndim == 2:
        data = data.reshape(-1, 3, size, size)
    # the source dtype (uint8) is kept: the loader converts per batch
    return data


def load_data(size=32, batch_size=100, seed=0, val_split=20_000,
              synthetic_ok=True):
    """(train, val, test) loaders; train shuffles with ``seed``."""
    base = os.path.join(os.environ.get("IFT_DATA_DIR", "./data"),
                        f"imagenet{size}")
    train = _load_shards(os.path.join(base, "train_data*"), size)
    test = _load_shards(os.path.join(base, "val_data*"), size)
    if train is None or test is None:
        if not synthetic_ok:
            raise FileNotFoundError(
                f"ImageNet{size} shards not found in {base}")
        warnings.warn(f"ImageNet{size} not found; using synthetic images")
        from .synthetic import load_data as synth
        return synth((3, size, size), n_train=2000, n_val=500, n_test=500,
                     batch_size=batch_size, seed=seed)
    idx = np.random.RandomState(seed).permutation(train.shape[0])
    val = train[idx[:val_split]]
    tr = train[idx[val_split:]]
    del train
    return (ArrayLoader(tr, batch_size, shuffle=True, seed=seed),
            ArrayLoader(val, batch_size, drop_last=False),
            ArrayLoader(test, batch_size, drop_last=False))
