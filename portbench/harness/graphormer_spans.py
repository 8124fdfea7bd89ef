"""What the graph transformer's per-layer readers share: a device span's
seconds over the untraced part of a training window."""

from __future__ import annotations

from typing import Optional


def device_seconds(r, name: str) -> Optional[float]:
    """Device seconds of the program's device span ``name`` summed over
    the ``train_epoch`` and ``evaluate`` units that closed after the
    newest profiled one of each kind, or None where their number is not
    the window's count of untraced epochs, the window is empty, or the
    program keeps no device spans."""
    try:
        from mgat_graphsage_torch.utils import telemetry
    except ImportError:
        return None
    window, epochs = r.counters.get("window_s"), r.counters.get("epochs")
    if not window or not epochs:
        return None
    total = 0.0
    for kind in ("train_epoch", "evaluate"):
        units = telemetry.unprofiled_tail(kind)
        if len(units) != epochs:
            return None
        spans = [getattr(u, "device", None) for u in units]
        if any(s is None or name not in s for s in spans):
            return None
        total += sum(s[name] for s in spans)
    return total
