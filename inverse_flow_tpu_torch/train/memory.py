"""Device-memory tracking.

Port of ``inverse_flow_tpu/train/memory.py:MemoryTracker`` on the CUDA
caching allocator's counters: allocated bytes, and the peak since the
previous snapshot (``torch.cuda.max_memory_allocated``, reset by
``reset_peak_memory_stats`` after each read, so each epoch reports its own
peak). The device is the CUDA card unless the caller names another; a
card named without an index is the process's current one (a data-parallel
rank's ``cuda:<LOCAL_RANK>``), fixed when the tracker is made. On a CPU
device there is nothing to read: a snapshot raises and ``log_to`` logs
nothing.
"""

from __future__ import annotations

from typing import Dict

import torch


class MemoryTracker:
    """Allocated / peak device memory across epochs, in MB."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.available = self.device.type == "cuda"
        self._base = 0
        if self.available and not torch.cuda.is_available():
            raise RuntimeError(f"MemoryTracker: no CUDA card for {device}")
        if self.available:
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def snapshot(self) -> Dict[str, float]:
        if not self.available:
            raise RuntimeError("MemoryTracker: no CUDA device to read")
        mb = 1.0 / (1024 * 1024)
        allocated = torch.cuda.memory_allocated(self.device)
        snap = {
            "allocated_mb": allocated * mb,
            "peak_mb": torch.cuda.max_memory_allocated(self.device) * mb,
            "delta_mb": (allocated - self._base) * mb,
            "limit_mb": torch.cuda.get_device_properties(
                self.device).total_memory * mb,
        }
        torch.cuda.reset_peak_memory_stats(self.device)
        return snap

    def log_to(self, logger, prefix: str = "Memory"):
        """Log a snapshot's values as ``"<prefix> <key>"``; nothing on a
        CPU device."""
        if not self.available:
            return
        for key, val in self.snapshot().items():
            logger.log(f"{prefix} {key}", val)
