"""Metrics logging: stdout and a local JSONL stream.

Copy of ``inverse_flow_tpu/train/metrics.py`` without wandb: the port
raises when asked for it. The JSONL file is opened at the first record, so
a run that logs nothing writes no file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str], use_wandb: bool = False,
                 verbose: bool = True):
        if use_wandb:
            raise NotImplementedError("the port has no wandb logging; "
                                      "metrics go to the JSONL file")
        self.path = path
        self.verbose = verbose
        self._fh = None

    def log(self, name, value, step=None):
        if self.verbose:
            print(f"{name}: {value}")
        if not self.path:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)
        rec = {"t": time.time(), "name": name, "value": _jsonable(value)}
        if step is not None:
            rec["step"] = step
        self._fh.write(json.dumps(rec) + "\n")

    def summary(self, name, value):
        self.log(f"summary/{name}", value)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
