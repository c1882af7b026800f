"""In-memory batch loader with per-epoch shuffling.

Port of ``inverse_flow_tpu/data/loader.py:ArrayLoader`` without the native
prefetch thread and the augmentation hooks (the scoring path uses
neither). Batches are float32 numpy arrays of raw 0-255 values; the
experiment moves them to its device.
"""

from __future__ import annotations

import numpy as np


class ArrayLoader:
    def __init__(self, data: np.ndarray, batch_size: int, shuffle=False,
                 seed: int = 0, drop_last=True):
        if data.ndim < 2:
            raise ValueError(f"ArrayLoader: data of shape {data.shape} has "
                             f"no batch axis")
        self.data = data
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.data_shape = tuple(data.shape[1:])

    def __len__(self):
        n = self.data.shape[0] // self.batch_size
        if not self.drop_last and self.data.shape[0] % self.batch_size:
            n += 1
        return max(1, n)

    def __iter__(self):
        idx = np.arange(self.data.shape[0])
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (len(idx) - self.batch_size + 1 if self.drop_last
                else len(idx))
        for start in range(0, max(1, stop), self.batch_size):
            yield self.data[idx[start:start + self.batch_size]].astype(
                np.float32)
