"""Streaming statistics recorder.

Numpy-only copy of ``inverse_flow_tpu/train/stats.py`` (Chan et al. batch
mean/std merge).
"""

from __future__ import annotations

import numpy as np


class StatsRecorder:
    def __init__(self, data=None):
        self.nobservations = 0
        self.mean = 0.0
        self.std = 0.0
        if data is not None:
            self.update(data)

    def update(self, data):
        data = np.asarray(data, dtype=np.float64)
        if data.size == 0:
            return
        if self.nobservations == 0:
            self.mean = data.mean(axis=0)
            self.std = data.std(axis=0)
            self.nobservations = data.shape[0]
            return

        if np.shape(self.mean) != data.shape[1:]:
            raise ValueError(
                f"StatsRecorder.update: feature shape {data.shape[1:]} "
                f"does not match recorded {np.shape(self.mean)}")
        newmean = data.mean(axis=0)
        newstd = data.std(axis=0)
        m = float(self.nobservations)
        n = data.shape[0]
        tmp = self.mean
        self.mean = m / (m + n) * tmp + n / (m + n) * newmean
        var = (m / (m + n) * self.std ** 2 + n / (m + n) * newstd ** 2
               + m * n / (m + n) ** 2 * (tmp - newmean) ** 2)
        self.std = np.sqrt(var)
        self.nobservations += n
