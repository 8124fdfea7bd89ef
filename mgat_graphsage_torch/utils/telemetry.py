"""Spans and units of work inside the program, by the host's clock.

- ``span(name)``: a context manager that adds the host seconds of its
  block to the open unit of the calling thread and to the process's
  totals.  While a ``torch`` profiler runs it is also a
  ``torch.profiler.record_function(name)``, so the span sits on the
  trace's clock beside the device's ops; with none running it enters
  none.  It never synchronises the device: its seconds are what the host
  spent inside the block (launching, or waiting where the block itself
  waits, as a copy to the host does);
- ``device_span(name, device)``: a span on the device's clock, for a
  region of work on a CUDA device: a pair of CUDA events recorded on the
  current stream around the block, kept on the open unit and resolved
  into its ``device`` seconds when the unit closes (after the unit's own
  host sync: it adds none; a pair whose end has not completed then is
  counted in ``device_unresolved`` instead).  The seconds cover whatever
  the stream did between the two events, host gaps included.  The unit
  is the calling thread's open one, else the newest open in the process:
  autograd runs a CUDA backward on a thread of its own, which opens no
  unit.  On any other device it records nothing;
- ``unit(kind, **counts)``: one record per unit of work
  (``train_epoch``, ``evaluate``, ``predict_call``) holding its spans'
  seconds, its counts, its wall seconds and ``profiled`` (a profiler ran
  at some point while it was open).  The open unit is the thread's own;
  closed records go into a bounded deque per kind, read by
  ``records(kind)``;
- ``snapshot()``: the process totals of every span and unit kind, with
  the launch counters the kernel wrappers keep (``launches``,
  ``launches_bf16``) and the native featuriser's counters (``calls``,
  ``parallel_calls``, ``molecules``, ``workers``), the graph
  transformers' attention calls by path (and those without a bias),
  structural bias builds by path, gated message calls by path with
  their real edges and edge slots, and EGT's gated attention calls by path
  with their real pairs and pair slots (``attention``,
  ``structural_bias``, ``gated_message``, ``gated_attention``) and the
  device spans' totals (``device_spans``), read from where they are
  kept.

Request threads and the serving dispatch thread use it at once: the totals
and the deques sit under one lock.  ``SPANS`` names every span the
program opens, device spans included.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["SPANS", "MAX_RECORDS", "Record", "Registry", "span",
           "device_span", "unit", "records", "unprofiled_tail", "snapshot"]

SPANS = (
    "train.forward",        # Trainer.train_step: forward and loss terms
    "train.backward",       # zero_grad and loss.backward()
    "train.optimizer",      # set_lr and optimizer.step
    "train.sync",           # train_epoch's one host read of the losses
    "eval.readback",        # Trainer.evaluate's copies to the host
    "predict.featurize",    # Predictor.__call__: the MolecularDataset
    "predict.dispatch",     # Predictor.__call__: predict_dataset
    "featurize.native",     # the native featuriser's one call
    "predict.upload",       # predict_dataset: the dataset to the device
    "predict.readback",     # predict_dataset: the predictions to the host
    "serve.queue_wait",     # serve.py: enqueue to its group's dispatch
    # device spans (device_span), models/zoo.py::GraphormerNet
    "graphormer.bias",      # the structural attention bias's build
    "graphormer.attention",  # each layer's attention, forward and backward
    "graphormer.bias_grad",  # the bias kernels' backward: the tables' sums
    # device span, ops/gated_message.py (models/zoo.py::GPSNet)
    "gps.message",          # each layer's gated message passing, fwd and bwd
    # device spans, models/layers.py::EGTLayer
    "egt.attention",        # each layer's gated attention, fwd and bwd
    "egt.pair",             # each layer's pair stream: its norms, products,
                            # FFN and residuals, fwd and bwd
)
MAX_RECORDS = 4096


@dataclasses.dataclass
class Record:
    """One unit of work: its kind, counts, span seconds by name, wall
    seconds, and whether a profiler ran while it was open."""
    kind: str
    counts: Dict[str, int]
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    profiled: bool = False
    # device spans: seconds on the device's clock by name, and the pairs of
    # events that had not completed when the unit closed
    device: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_unresolved: int = 0
    pending: List = dataclasses.field(default_factory=list, repr=False)


class _Span:
    __slots__ = ("_reg", "name", "seconds", "_t0", "_rf")

    def __init__(self, reg: "Registry", name: str):
        self._reg = reg
        self.name = name
        self.seconds = 0.0
        self._rf = None

    def __enter__(self) -> "_Span":
        # the profiler's own flag, set while any torch profiler runs
        if _autograd_profiler._is_profiler_enabled:
            rec = getattr(self._reg._local, "unit", None)
            if rec is not None:
                rec.profiled = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.seconds = ns * 1e-9
        self._reg._add_span(self.name, ns)


class _DeviceSpan:
    __slots__ = ("_reg", "name", "_on", "_rec", "_start", "_rf")

    def __init__(self, reg: "Registry", name: str, on: bool):
        self._reg = reg
        self.name = name
        self._on = on
        self._rec = self._start = self._rf = None

    def __enter__(self) -> "_DeviceSpan":
        if not self._on:
            return self
        self._rec = self._reg._open_unit()
        if self._rec is None:
            return self
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()
        return self

    def __exit__(self, *exc) -> None:
        if self._start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        with self._reg._lock:
            self._rec.pending.append((self.name, self._start, end))
        self._start = None


class _Unit:
    __slots__ = ("_reg", "record", "_prev", "_t0")

    def __init__(self, reg: "Registry", kind: str, counts: Dict[str, int]):
        self._reg = reg
        self.record = Record(kind, dict(counts))

    def __enter__(self) -> Record:
        local = self._reg._local
        self._prev = getattr(local, "unit", None)
        local.unit = self.record
        self.record.profiled = _autograd_profiler._is_profiler_enabled
        with self._reg._lock:
            self._reg._open.append(self.record)
        self._t0 = time.perf_counter_ns()
        return self.record

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        rec = self.record
        rec.wall_s = ns * 1e-9
        rec.profiled = rec.profiled or \
            _autograd_profiler._is_profiler_enabled
        self._reg._local.unit = self._prev
        self._reg._close(rec, ns)


class Registry:
    """Span totals, unit records and the thread's open unit; the module's
    functions use one registry for the process."""

    def __init__(self, max_records: int = MAX_RECORDS):
        self.max_records = int(max_records)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: Dict[str, List[int]] = {}     # name -> [ns, count]
        self._units: Dict[str, List[int]] = {}     # kind -> [ns, count]
        self._records: Dict[str, Deque[Record]] = {}
        self._device: Dict[str, List[float]] = {}  # name -> [s, count]
        self._open: List[Record] = []              # open units, any thread

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def unit(self, kind: str, **counts: int) -> _Unit:
        return _Unit(self, kind, counts)

    def device_span(self, name: str, device) -> _DeviceSpan:
        """A span on the device's clock (the module docstring); ``device``
        is where the block's work runs, and only a CUDA one records."""
        return _DeviceSpan(self, name, torch.device(device).type == "cuda")

    def _open_unit(self) -> Optional[Record]:
        rec = getattr(self._local, "unit", None)
        if rec is not None:
            return rec
        with self._lock:
            return self._open[-1] if self._open else None

    def _add_span(self, name: str, ns: int) -> None:
        rec: Optional[Record] = getattr(self._local, "unit", None)
        if rec is not None:
            rec.spans[name] = rec.spans.get(name, 0.0) + ns * 1e-9
        with self._lock:
            tot = self._spans.get(name)
            if tot is None:
                self._spans[name] = [ns, 1]
            else:
                tot[0] += ns
                tot[1] += 1

    def _close(self, rec: Record, ns: int) -> None:
        with self._lock:
            for i in range(len(self._open) - 1, -1, -1):
                if self._open[i] is rec:
                    del self._open[i]
                    break
            pending, rec.pending = rec.pending, []
        for name, start, end in pending:
            if not end.query():
                rec.device_unresolved += 1
                continue
            sec = start.elapsed_time(end) * 1e-3
            rec.device[name] = rec.device.get(name, 0.0) + sec
            with self._lock:
                tot = self._device.setdefault(name, [0.0, 0])
                tot[0] += sec
                tot[1] += 1
        with self._lock:
            q = self._records.get(rec.kind)
            if q is None:
                q = self._records[rec.kind] = collections.deque(
                    maxlen=self.max_records)
            q.append(rec)
            tot = self._units.setdefault(rec.kind, [0, 0])
            tot[0] += ns
            tot[1] += 1

    def records(self, kind: str) -> List[Record]:
        """The closed records of ``kind``, oldest first (at most
        ``max_records``)."""
        with self._lock:
            return list(self._records.get(kind, ()))

    def unprofiled_tail(self, kind: str) -> List[Record]:
        """The records of ``kind`` closed after the newest profiled one: in
        a run profiled from its start for a while, the units that ran after
        the profiler stopped."""
        recs = self.records(kind)
        last = max((i for i, r in enumerate(recs) if r.profiled), default=-1)
        return recs[last + 1:]

    def snapshot(self) -> Dict:
        """``{"spans": {name: {"seconds", "count"}}, "units": {kind:
        {"seconds", "count"}}, "launches": {wrapper: count}, "featurize":
        {counter: count}, "attention": {path: calls}, "structural_bias":
        {path: calls}, "gated_message": {counter: count},
        "gated_attention": {counter: count}, "device_spans": {name:
        {"seconds", "count"}}}``: the process totals, JSON-ready."""
        with self._lock:
            spans = {k: {"seconds": v[0] * 1e-9, "count": v[1]}
                     for k, v in self._spans.items()}
            units = {k: {"seconds": v[0] * 1e-9, "count": v[1]}
                     for k, v in self._units.items()}
            device = {k: {"seconds": v[0], "count": v[1]}
                      for k, v in self._device.items()}
        from ..chem import native
        from ..ops import biased_attention, gated_message, structural_bias

        return {"spans": spans, "units": units, "launches": _launches(),
                "featurize": native.counts(),
                "attention": biased_attention.counts(),
                "structural_bias": structural_bias.counts(),
                "gated_message": gated_message.counts(),
                "gated_attention": biased_attention.gated_counts(),
                "device_spans": device}


def _launches() -> Dict[str, int]:
    """The kernel wrappers' own launch counters, by wrapper name (bf16
    launches as ``<name>_bf16``)."""
    from ..ops import (adjacency, attention, biased_attention, cnn,
                       gated_message, structural_bias)

    out = {}
    for mod, name in ((adjacency, "dense_adjacency_cuda"),
                      (attention, "fused_masked_attention_cuda"),
                      (attention, "attention_bwd_cuda"),
                      (cnn, "dy3_cuda"), (cnn, "cnn_chain_bwd_cuda"),
                      (biased_attention, "biased_attention_cuda"),
                      (biased_attention, "biased_attention_bwd_cuda"),
                      (biased_attention, "gated_attention_cuda"),
                      (biased_attention, "gated_attention_bwd_cuda"),
                      (structural_bias, "structural_bias_cuda"),
                      (structural_bias, "structural_bias_bwd_cuda"),
                      (gated_message, "gated_message_cuda"),
                      (gated_message, "gated_message_bwd_cuda")):
        # the name the wrapper is looked up by, in its defining module
        fn = getattr(mod, name)
        for attr in ("launches", "launches_bf16"):
            if hasattr(fn, attr):
                out[name + attr[len("launches"):]] = int(getattr(fn, attr))
    return out


_REGISTRY = Registry()
span = _REGISTRY.span
device_span = _REGISTRY.device_span
unit = _REGISTRY.unit
records = _REGISTRY.records
unprofiled_tail = _REGISTRY.unprofiled_tail
snapshot = _REGISTRY.snapshot
