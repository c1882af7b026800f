"""The embedded real handwritten digits: 1,797 8x8 UCI scans.

Numpy-only copy of ``inverse_flow_tpu/data/digits.py``. It reads the IDX
files that the JAX package carries (``inverse_flow_tpu/data/embedded/``) by
path, through the port's own IDX parser, and splits them as JAX does:
1437 train / 180 val from the training file, 180 test. Values are raw
0-240 in steps of 15.
"""

from __future__ import annotations

import os

import numpy as np

from .loader import ArrayLoader
from .mnist import _read_idx

SHAPE = (1, 8, 8)

EMBEDDED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "inverse_flow_tpu", "data", "embedded")


def load_arrays():
    """(train_1617, test_180) as (N, 1, 8, 8) float32 raw values."""
    tr = _read_idx(os.path.join(EMBEDDED, "digits-train-images-idx3-ubyte"))
    te = _read_idx(os.path.join(EMBEDDED, "digits-test-images-idx3-ubyte"))
    return tr.astype(np.float32)[:, None], te.astype(np.float32)[:, None]


def load_data(batch_size=100, seed=0, train_split=1437, **kwargs):
    """(train, val, test) loaders; val and test keep their last partial
    batch."""
    train_all, test = load_arrays()
    return (ArrayLoader(train_all[:train_split], batch_size, shuffle=True,
                        seed=seed),
            ArrayLoader(train_all[train_split:], batch_size, shuffle=False,
                        drop_last=False),
            ArrayLoader(test, batch_size, shuffle=False, drop_last=False))
