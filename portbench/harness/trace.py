"""Spans, and the reduction of a ``torch.profiler`` trace to what the
per-layer metrics read.

Every run keeps host spans (seconds inside each named span, by the
host's clock, over the untraced part of the window).  A traced run
(``--trace 1``) also runs the profiler over the first ``trace_seconds``
of the window (whole units of work: the unit that crosses the mark ends
the trace; a mix without ``trace_seconds`` is traced whole), with each
span also a ``record_function`` so that the trace knows what the host
was doing.  ``trace_host: false`` in a mix leaves out the CPU activity.  From the trace: the device's busy seconds (the
union of kernel, copy and set intervals), the traced window's length,
device time by operation name, and the idle seconds by the host span that
was open.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"


class Tracer:
    def __init__(self, torch, traced: bool, trace_seconds: float,
                 host_activity: bool = True):
        self.torch = torch
        self.traced = traced
        self.trace_seconds = float(trace_seconds)
        # without the CPU activity the profiler records no host op and no
        # span (the window is the host clock's), and costs a served
        # program's threads far less
        self.host_activity = host_activity
        self.unrecorded: List[str] = []   # spans the trace cannot see
        self.spans: Dict[str, float] = defaultdict(float)
        self.names = {WINDOW}
        self.synthetic: List[Tuple[str, list]] = []
        self._prof = None
        self._window = None
        self.t_begin: Optional[float] = None
        # when the window went on untraced: host-clock metrics of a traced
        # run are read from there on, clear of the profiler's overhead
        self.t_resume: Optional[float] = None
        self.summary: Optional["TraceSummary"] = None

    def _activities(self):
        prof = self.torch.profiler
        cuda = [a for a in prof.supported_activities()
                if a == prof.ProfilerActivity.CUDA]
        host = [prof.ProfilerActivity.CPU] \
            if self.host_activity or not cuda else []
        return host + cuda

    def warm_up(self, device) -> None:
        """In a traced run, start and stop the profiler once in set-up:
        its first start initialises CUPTI, which takes seconds."""
        if not self.traced:
            return
        with self.torch.profiler.profile(activities=self._activities()):
            (self.torch.ones(8, device=device) + 1).sum().item()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        """Start the profiler (in a traced run) at the window's start."""
        if not self.traced:
            return
        prof = self.torch.profiler
        self._prof = prof.profile(activities=self._activities())
        self._prof.__enter__()
        self._window = prof.record_function(WINDOW) if self.host_activity \
            else contextlib.nullcontext()
        self._window.__enter__()
        self.t_begin = time.perf_counter()

    def due(self) -> bool:
        """Whether the traced part of the window has run its length."""
        return self.active and \
            time.perf_counter() - self.t_begin >= self.trace_seconds

    def stop(self) -> None:
        if not self.active:
            return
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        host_s = time.perf_counter() - self.t_begin
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.summary = reduce_events(
            prof.events(), self.names, self.synthetic, host_s,
            self.unrecorded[-1] if self.unrecorded else "other")
        self.t_resume = time.perf_counter()

    def untraced(self, t: float) -> bool:
        """Whether a unit of work that started at ``t`` ran untraced."""
        return self.t_resume is None or t >= self.t_resume

    @contextlib.contextmanager
    def span(self, name: str):
        """A named host span (a ``record_function`` while tracing); its
        seconds are summed over the untraced part of the window."""
        self.names.add(name)
        traced = self.active
        rf = self.torch.profiler.record_function(name) \
            if traced and self.host_activity else contextlib.nullcontext()
        if traced and not self.host_activity:
            self.unrecorded.append(name)
        t0 = time.perf_counter()
        with rf:
            yield
        if not traced:
            self.spans[name] += time.perf_counter() - t0

    def split_last(self, parent: str, parts: List[Tuple[str, float]]) -> None:
        """Name the first seconds of the latest ``parent`` span after
        ``parts`` in turn (seconds measured inside it, such as the
        program's own split of a call), for the idle gaps' names."""
        if self.active:
            for name, _ in parts:
                self.names.add(name)
            self.synthetic.append((parent, parts))


class TraceSummary:
    def __init__(self, busy_s, window_s, ops, idle):
        self.busy_s = busy_s
        self.window_s = window_s
        self.ops = ops          # device op name -> (seconds, count)
        self.idle = idle        # host span name -> idle seconds

    def kernel(self, needle: str) -> Tuple[float, int]:
        """(seconds, launches) of the device ops whose name holds
        ``needle``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.ops.items():
            if needle in name:
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> Dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def reduce_events(events, names, synthetic, host_s: float,
                  default: str = "other") -> TraceSummary:
    """``host_s``: the traced window by the host's clock, for a trace with
    no host activity (no window span): it then starts at the first device
    op.  An idle gap in no span is named ``default``."""
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if win:
        ws, we = win[0].time_range.start, win[0].time_range.end
    else:
        ws = min((e.time_range.start for e in events if _is_device(e)),
                 default=0.0)
        we = ws + host_s * 1e6
    dev, host = [], []
    for e in events:
        if e.name in names:
            if not _is_device(e):
                host.append((e.name, e.time_range.start, e.time_range.end))
            continue   # a span's copy on the device is no device work
        if _is_device(e) and not getattr(e, "is_user_annotation", False):
            dev.append((e.name, e.time_range.start, e.time_range.end))
    # the program's own split of a span (seconds from its start)
    by_parent = defaultdict(list)
    for name, s, t in sorted(host, key=lambda h: h[1]):
        by_parent[name].append((s, t))
    seen = defaultdict(int)
    for parent, parts in synthetic:
        k = seen[parent]
        seen[parent] += 1
        if k >= len(by_parent[parent]):
            continue
        s, t = by_parent[parent][k]
        for name, sec in parts:
            e = min(s + sec * 1e6, t)
            host.append((name, s, e))
            s = e
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    ivs = []
    for name, s, t in dev:
        s, t = max(s, ws), min(t, we)
        if t <= s:
            continue
        ops[name][0] += (t - s) / 1e6
        ops[name][1] += 1
        ivs.append((s, t))
    ivs.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, ws
    for s, t in ivs:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_s is not None:
        busy += cur_e - cur_s
    if we > cur_e:
        gaps.append((cur_e, we))
    idle: Dict[str, float] = defaultdict(float)
    spans = sorted(host, key=lambda h: h[2] - h[1])   # innermost first
    for s, t in gaps:
        mid = 0.5 * (s + t)
        name = next((n for n, a, b in spans if a <= mid <= b
                     and n != WINDOW), default)
        idle[name] += (t - s) / 1e6
    return TraceSummary(busy / 1e6, (we - ws) / 1e6,
                        {k: (v[0], int(v[1])) for k, v in ops.items()},
                        dict(idle))
