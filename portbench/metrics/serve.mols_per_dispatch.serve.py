"""Molecules per device dispatch over the window: the difference of the
server's own ``/health`` counters ``molecules_served`` and
``device_dispatches`` across the window."""


def read(r):
    d = r.counters.get("device_dispatches")
    if not d:
        return None
    return r.counters["molecules_served"] / d
