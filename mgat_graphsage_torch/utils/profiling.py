"""Profiling hooks (the port's copy of
``mgat_graphsage_tpu/utils/profiling.py``; the reference has no tracing at
all, only wall-clock prints in ``pycaret.py:296``).

- ``trace(logdir)``: context manager around a ``torch.profiler`` trace of
  the host and, where there is one, the CUDA device, written as a Chrome
  trace (``<logdir>/trace.json``, viewable in Perfetto or
  ``chrome://tracing``), with the program's spans (``utils/telemetry.py``)
  in it by name;
- ``device_memory_stats()``: per-CUDA-device allocator statistics.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

__all__ = ["trace", "device_memory_stats"]


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
