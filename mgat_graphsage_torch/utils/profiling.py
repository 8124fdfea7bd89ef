"""Profiling hooks (the port's copy of
``mgat_graphsage_tpu/utils/profiling.py``; the reference has no tracing at
all, only wall-clock prints in ``pycaret.py:296``).

- ``trace(logdir)``: context manager around a ``torch.profiler`` trace of
  the host and, where there is one, the CUDA device, written as a Chrome
  trace (``<logdir>/trace.json``, viewable in Perfetto or
  ``chrome://tracing``);
- ``StepTimer``: cheap per-step wall-clock stats (mean/p50/p95) that the
  trainer can report without a profiler attached.  It reads the host's
  clock, as the reference package's does: a caller timing device work
  synchronises first;
- ``device_memory_stats()``: per-CUDA-device allocator statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["trace", "StepTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU, and
    CUDA when available) into ``<logdir>/trace.json``; the profiler stops
    on an error too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling wall-clock statistics for training steps."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps": len(arr),
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:<i> (<name>)": {stat: int}}`` from
    ``torch.cuda.memory_stats`` for every CUDA device (allocated, reserved
    and active bytes, current and peak, ...); empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i} ({torch.cuda.get_device_name(i)})"] = {
            k: int(v) for k, v in stats.items()
            if isinstance(v, (int, float))}
    return out
