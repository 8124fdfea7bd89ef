"""Helpers the per-layer readers (``portbench/metrics/``) share.  A reader
that finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Optional

from . import flops


def idle_share(r) -> Optional[float]:
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(r, kind: str, needle: str, phase: str) -> Optional[float]:
    """``kind``'s least time for the batches of ``phase`` (``forward`` or
    ``backward``) that ran in the traced window, over the device time of
    the ops whose name holds ``needle``."""
    t = r.trace
    batches = (r.traced or {}).get(phase)
    if t is None or not batches:
        return None
    seconds, launches = t.kernel(needle)
    if launches == 0 or seconds <= 0:
        return None
    n, e = r.config["budget"]
    least = flops.kernel_bound_s(kind, batches, n, e,
                                 r.config["model"]["in_features"])
    return 100.0 * least / seconds
