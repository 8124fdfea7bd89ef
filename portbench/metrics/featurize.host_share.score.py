"""Share of the window the host spent featurising: the sum of the
program's own ``Predictor.last_timings["featurize_s"]`` over the window's
calls, over the window."""


def read(r):
    window = r.counters.get("window_s")
    if not window or not r.counters.get("molecules"):
        return None
    return 100.0 * r.counters["featurize_s"] / window
