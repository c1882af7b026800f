"""The embedded real RGB patches: 2,080 16x16 patches of two photographs.

Numpy-only copy of ``inverse_flow_tpu/data/patches.py``. It reads the
``patches16.npz`` that the JAX package carries
(``inverse_flow_tpu/data/embedded/``) by path. Values are raw uint8 0-255.
"""

from __future__ import annotations

import os

import numpy as np

from .digits import EMBEDDED
from .loader import ArrayLoader

SHAPE = (3, 16, 16)

_PATH = os.path.join(EMBEDDED, "patches16.npz")


def load_arrays():
    """(train, val, test) as (N, 3, 16, 16) float32 raw 0-255 values."""
    with np.load(_PATH) as z:
        return (z["train"].astype(np.float32),
                z["val"].astype(np.float32),
                z["test"].astype(np.float32))


def load_data(batch_size=100, seed=0, **kwargs):
    train, val, test = load_arrays()
    return (ArrayLoader(train, batch_size, shuffle=True, seed=seed),
            ArrayLoader(val, batch_size, shuffle=False, drop_last=False),
            ArrayLoader(test, batch_size, shuffle=False, drop_last=False))
