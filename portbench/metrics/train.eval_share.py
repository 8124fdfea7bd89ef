"""Share of the training window inside ``Trainer.evaluate`` (the
benchmark's span around each call)."""


def read(r):
    window = r.counters.get("window_s")
    if not window or not r.counters.get("epochs") or "evaluate" not in r.spans:
        return None
    return 100.0 * r.spans["evaluate"] / window
