"""Metric logging, step timing, traces and device memory, and a bounded
CUDA probe (the port's copy of ``mgat_graphsage_tpu/utils``)."""

from .backend import probe_backend
from .logging import MetricLogger, read_jsonl
from .profiling import StepTimer, device_memory_stats, trace

__all__ = ["MetricLogger", "read_jsonl", "StepTimer",
           "device_memory_stats", "trace", "probe_backend"]
