"""Profiler traces.

Port of ``inverse_flow_tpu/utils/profiling.py:trace`` on ``torch.profiler``:
host and CUDA activity of the block, written as a Chrome trace into
``profile_dir``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Trace the block into ``profile_dir/trace.json`` (a no-op for
    None). CUDA activity is recorded when a card is present."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
