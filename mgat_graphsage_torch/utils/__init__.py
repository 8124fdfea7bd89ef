"""Metric logging, traces and device memory, and a bounded CUDA probe (the
port's copy of ``mgat_graphsage_tpu/utils``); the program's spans and
units of work (``telemetry``)."""

from .backend import probe_backend
from .logging import MetricLogger, read_jsonl
from .profiling import device_memory_stats, trace

__all__ = ["MetricLogger", "read_jsonl", "device_memory_stats", "trace",
           "probe_backend"]
