"""MNIST loader: 50k train / 10k val / 10k test.

Port of ``inverse_flow_tpu/data/mnist.py`` without augmentation. Reads the
standard IDX files (``train-images-idx3-ubyte[.gz]``,
``t10k-images-idx3-ubyte[.gz]``) from ``$IFT_DATA_DIR/mnist`` or
``./data/mnist``. If they are absent it falls back, with a warning, to the
deterministic synthetic images of the same shape that the JAX package
uses.
"""

from __future__ import annotations

import gzip
import os
import warnings

import numpy as np

from .loader import ArrayLoader

SHAPE = (1, 28, 28)

_TRAIN_IMAGES = "train-images-idx3-ubyte"
_TEST_IMAGES = "t10k-images-idx3-ubyte"


def _data_dir():
    return os.path.join(os.environ.get("IFT_DATA_DIR", "./data"), "mnist")


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = int.from_bytes(data[0:4], "big") & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find(name):
    for suffix in ("", ".gz"):
        p = os.path.join(_data_dir(), name + suffix)
        if os.path.exists(p):
            return p
    return None


def load_arrays():
    """(train_60k, test_10k) as (N, 1, 28, 28) float32 in [0, 255], or
    None when the files are absent."""
    tr, te = _find(_TRAIN_IMAGES), _find(_TEST_IMAGES)
    if tr is None or te is None:
        return None
    return (_read_idx(tr).astype(np.float32)[:, None],
            _read_idx(te).astype(np.float32)[:, None])


def load_data(batch_size=100, seed=0, train_split=50_000):
    """(train, val, test) loaders; train shuffles with ``seed``."""
    arrays = load_arrays()
    if arrays is None:
        warnings.warn(
            "MNIST files not found; using deterministic synthetic images "
            f"(place idx files under {_data_dir()} for the real dataset)")
        from .synthetic import load_data as synth
        return synth(SHAPE, n_train=2000, n_val=500, n_test=500,
                     batch_size=batch_size, seed=seed)
    train_all, test = arrays
    return (ArrayLoader(train_all[:train_split], batch_size, shuffle=True,
                        seed=seed),
            ArrayLoader(train_all[train_split:], batch_size,
                        drop_last=False),
            ArrayLoader(test, batch_size, drop_last=False))
