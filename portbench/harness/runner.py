"""One run of one cell: the environment, the set-up clock, the driver of
the cell's traffic, the correctness checks, the per-layer readers, and
the result line.

A driver (``harness/drivers/<traffic["driver"]>.py``) has one function,
``run(ctx) -> Outcome``: it sets up the program, warms it up, measures
the window (``ctx.window_started()`` marks its start), reads the memory
peak, frees the program's state and runs the checks against the
reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from collections import OrderedDict
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mgat_graphsage_tpu")


class NoDevice(RuntimeError):
    """The run finds fewer CUDA devices than its cell asks for."""


def prepare_env(root: str) -> None:
    """Fixed cache directories inside the checkout, set before torch or the
    program is imported; keep libraries from loading JAX."""
    cache = os.path.join(root, "portbench", ".cache")
    os.environ["MGAT_TORCH_BUILD_DIR"] = os.path.join(cache, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    traced: Dict = dataclasses.field(default_factory=dict)


class Context:
    """What a driver is given."""

    def __init__(self, spec, cell: Dict, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float,
                 phases: "OrderedDict[str, float]"):
        import torch

        from .trace import Tracer

        self.torch = torch
        self.spec = spec
        self.cell = cell
        self.config = spec.config(cell["config"])
        self.traffic = spec.traffic(cell["traffic"])
        self.limits = spec.limits(cell["name"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.phases = phases
        self.t_window: Optional[float] = None
        self.tracer = Tracer(torch, self.trace,
                             self.traffic.get("trace_seconds", seconds),
                             self.traffic.get("trace_host", True))
        self.tmpdir = tempfile.mkdtemp(prefix="portbench-")

    def log(self, *a) -> None:
        print(*a, file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def phase(self, name: str):
        """A named part of set-up, timed by the host's clock."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.phases[name] = self.phases.get(name, 0.0) + \
            time.perf_counter() - t0

    def window_started(self) -> float:
        """Mark the start of the measured window (the end of set-up), and
        start the profiler in a traced run."""
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.t_window = time.perf_counter()
        self.tracer.start()
        return self.t_window

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def limit(self, name: str) -> float:
        return float(self.limits[name]["limit"])


class Reading:
    """What a per-layer metric's reader is given."""

    def __init__(self, ctx: Context, out: Outcome):
        self.cell = ctx.cell
        self.config = ctx.config
        self.traffic = ctx.traffic
        self.spans = dict(ctx.tracer.spans)
        self.counters = out.counters
        self.traced = out.traced
        self.trace = ctx.tracer.summary


def run(spec, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> Dict:
    """Run one cell; return the result line's object (``checks`` last).
    ``t_start`` is the process's start by ``time.perf_counter()``."""
    phases: "OrderedDict[str, float]" = OrderedDict()
    t = time.perf_counter()
    phases["interpreter"] = t - t_start
    import torch

    import mgat_graphsage_torch.serve  # noqa: F401
    import mgat_graphsage_torch.train  # noqa: F401
    phases["import"] = time.perf_counter() - t
    cell = spec.cell(workload)
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(cell["chips"]):
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA "
                           f"device(s); this machine has {have}")
        t = time.perf_counter()
        torch.zeros(1, device=device).add_(1).cpu()
        phases["cuda_context"] = time.perf_counter() - t
    ctx = Context(spec, cell, seed, seconds, trace, device, t_start, phases)
    with ctx.phase("kernels"):
        # the cell's kernels and the native featuriser, built in the
        # checkout's cache on a first run, loaded from it after
        from mgat_graphsage_torch.chem import native
        from mgat_graphsage_torch.ops import _build

        native.get_lib()
        if device == "cuda":
            for name in ctx.traffic.get("kernels", []):
                _build.load(name)
    with ctx.phase("profiler"):
        ctx.tracer.warm_up(ctx.device)
    driver = importlib.import_module(
        f"portbench.harness.drivers.{ctx.traffic['driver']}")
    try:
        out = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.tmpdir, ignore_errors=True)
    setup_s = ctx.t_window - t_start
    for name, sec in ctx.phases.items():
        ctx.log(f"setup {name}: {sec:.3f} s")
    ctx.log(f"setup_s: {setup_s:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("the run loaded " + ", ".join(bad))

    if not trace:
        metrics = {}
        for m in spec.end_to_end(workload):
            value = setup_s if m["name"] == "setup_s" \
                else out.metrics[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        reading = Reading(ctx, out)
        metrics = {}
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(c.ok for c in out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    summary = ctx.tracer.summary
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["counters"] = out.counters
    result["setup"] = dict(ctx.phases)
    for c in out.checks:
        ctx.log(f"check {c.name}: {c.value!r} limit {c.limit!r} "
                f"{'ok' if c.ok else 'FAILED'}")
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result


def dumps(result: Dict) -> str:
    return json.dumps(result, allow_nan=False)
