"""CIFAR-10 loader: 40k train / 10k val / 10k test, with augmentation.

Port of ``inverse_flow_tpu/data/cifar10.py``. Reads the python-pickle
batches (``data_batch_1``..``_5``, ``test_batch``) from
``$IFT_DATA_DIR/cifar-10-batches-py`` (or ``.../cifar10/cifar-10-batches-
py``; ``$IFT_DATA_DIR`` defaults to ``./data``). The train split is
augmented as the reference: flip -> edge-pad(2), integer affine
translate, center crop -> flip (the second flip kept). If the batches
are absent it falls back, with a warning, to the deterministic synthetic
images the JAX package uses (2000 / 500 / 500).
"""

from __future__ import annotations

import os
import pickle
import warnings

import numpy as np

from .loader import ArrayLoader, affine_translate_crop, compose, \
    random_flip_lr

SHAPE = (3, 32, 32)


def _data_dir():
    base = os.environ.get("IFT_DATA_DIR", "./data")
    for cand in (os.path.join(base, "cifar-10-batches-py"),
                 os.path.join(base, "cifar10", "cifar-10-batches-py")):
        if os.path.isdir(cand):
            return cand
    return None


def _read_batch(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")[b"data"]


def load_arrays():
    """(train_50k, test_10k) as (N, 3, 32, 32) float32 in [0, 255], or None
    when the batches are absent."""
    d = _data_dir()
    if d is None:
        return None
    train = np.concatenate([_read_batch(os.path.join(d, f"data_batch_{i}"))
                            for i in range(1, 6)]).reshape(-1, *SHAPE)
    test = _read_batch(os.path.join(d, "test_batch")).reshape(-1, *SHAPE)
    return train.astype(np.float32), test.astype(np.float32)


def load_data(data_aug=True, batch_size=100, seed=0, synthetic_ok=True,
              train_split=40_000):
    """(train, val, test) loaders; train shuffles with ``seed`` and, with
    ``data_aug``, augments; ``synthetic_ok=False`` raises when the batches
    are absent."""
    arrays = load_arrays()
    if arrays is None:
        if not synthetic_ok:
            raise FileNotFoundError("CIFAR-10 batches not found")
        warnings.warn("CIFAR-10 not found; using synthetic images")
        from .synthetic import load_data as synth
        return synth(SHAPE, n_train=2000, n_val=500, n_test=500,
                     batch_size=batch_size, seed=seed)
    train_all, test = arrays
    augment = (compose(random_flip_lr, affine_translate_crop(2),
                       random_flip_lr) if data_aug else None)
    return (ArrayLoader(train_all[:train_split], batch_size, shuffle=True,
                        seed=seed, augment=augment),
            ArrayLoader(train_all[train_split:], batch_size,
                        drop_last=False),
            ArrayLoader(test, batch_size, drop_last=False))
