"""Peak memory of a solve, the reference's memory metric.

Counterpart of ``ttipm_tpu/utils/memtrack.py`` without ``psutil`` (which the
GPU machine does not have).  On a CUDA device the peak is
``torch.cuda.max_memory_allocated`` over the tracked region (its counter is
reset on entry).  On the CPU it is the process's resident high-water mark
``VmHWM`` from ``/proc/self/status`` at exit less its resident size
``VmRSS`` at entry: the kernel keeps one high-water mark per process, so a
peak reached before the region can hide the region's own.
"""

from __future__ import annotations

from typing import Callable, Tuple, TypeVar

import torch

__all__ = ["PeakMemoryTracker", "measure_peak_rss", "proc_status_bytes"]

T = TypeVar("T")


def proc_status_bytes(field: str) -> int:
    """A ``kB`` field of ``/proc/self/status`` in bytes (0 where the file
    or the field is missing)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class PeakMemoryTracker:
    """Context manager around a solve on ``device``; ``peak_mb`` holds the
    peak (MB, 1e6 bytes) once it has exited."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.peak_bytes = 0
        self._baseline = 0

    def __enter__(self) -> "PeakMemoryTracker":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        else:
            self._baseline = proc_status_bytes("VmRSS")
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        else:
            self.peak_bytes = max(0, proc_status_bytes("VmHWM") - self._baseline)

    @property
    def peak_mb(self) -> float:
        return self.peak_bytes / 1e6


def measure_peak_rss(fn: Callable[[], T], device="cpu") -> Tuple[float, T]:
    """Run ``fn`` under ``PeakMemoryTracker(device)``; returns (peak MB,
    result): the device's peak allocation on CUDA, the resident peak over
    the region on the CPU."""
    with PeakMemoryTracker(device) as tracker:
        result = fn()
    return tracker.peak_mb, result
