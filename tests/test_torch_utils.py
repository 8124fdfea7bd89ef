"""The port's tooling (``utils/``): metric logging (a copy of the reference
package's, mirroring ``tests/test_utils.py``), the ``torch.profiler``
trace, CUDA memory statistics and the bounded CUDA probe, on the CPU (the
spans and units of ``utils/telemetry.py``: ``tests/test_torch_telemetry.py``)."""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.utils import (
    MetricLogger,
    device_memory_stats,
    probe_backend,
    read_jsonl,
    trace,
)
from mgat_graphsage_torch.utils import backend


def test_metric_logger_jsonl_and_csv(tmp_path):
    jp = str(tmp_path / "m.jsonl")
    cp = str(tmp_path / "m.csv")
    log = MetricLogger(jsonl_path=jp, csv_path=cp)
    log.log({"loss": 1.5, "mse": 2.0}, step=1)
    log.log({"loss": 1.0, "mse": 1.5}, step=2)
    rows = read_jsonl(jp)
    assert len(rows) == 2
    assert rows[0]["loss"] == 1.5 and rows[1]["step"] == 2
    lines = open(cp).read().strip().split("\n")
    assert len(lines) == 3  # header + 2 rows
    assert "loss" in lines[0]
    # non-scalar values are dropped, not crashed on
    log.log({"loss": 0.5, "array": np.zeros(3), "note": "ok"}, step=3)
    assert "array" not in read_jsonl(jp)[-1]
    assert read_jsonl(jp)[-1]["note"] == "ok"


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    path = os.path.join(logdir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)


def test_trace_stops_on_error(tmp_path):
    # the finally-block stops the profiler, so a later trace can start
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path / "t1")):
            raise RuntimeError("boom")
    assert os.path.exists(tmp_path / "t1" / "trace.json")
    with trace(str(tmp_path / "t2")):
        (torch.zeros(8) + 1).sum().item()


def test_device_memory_stats_names_each_card(monkeypatch):
    """One entry per CUDA device, named by index and card, int values;
    empty without CUDA (as here)."""
    assert device_memory_stats() == ({} if not torch.cuda.is_available()
                                     else device_memory_stats())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"Card {i}")
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: {"allocated_bytes.all.current": 512 * i,
                                   "num_alloc_retries": 0.0})
    stats = device_memory_stats()
    assert list(stats) == ["cuda:0 (Card 0)", "cuda:1 (Card 1)"]
    assert stats["cuda:1 (Card 1)"] == {"allocated_bytes.all.current": 512,
                                        "num_alloc_retries": 0}


def test_probe_backend_raises_without_cuda_and_on_a_timeout(monkeypatch):
    """No CPU fallback: the probe says ``cuda`` or raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            probe_backend(timeout_s=120)

    def hang(*a, **k):
        raise subprocess.TimeoutExpired(a[0], k.get("timeout"))

    monkeypatch.setattr(backend.subprocess, "run", hang)
    with pytest.raises(RuntimeError, match="within 5s"):
        probe_backend(timeout_s=5)


def test_probe_backend_reads_the_probe_answer(monkeypatch):
    monkeypatch.setattr(
        backend.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a[0], 0, "cuda\n", ""))
    assert probe_backend() == "cuda"
