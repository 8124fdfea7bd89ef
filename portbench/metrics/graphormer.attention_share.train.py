"""Share of the untraced training window that the device spends in the
graph transformer's attention: the ``graphormer.attention`` device span
(``ops/biased_attention.py``, forward and backward, each layer) summed
over the ``train_epoch`` and ``evaluate`` units of ``utils/telemetry.py``
that closed after the newest profiled ones, over the window.  Nothing
where their number is not the window's epochs, or the program keeps no
device spans."""

from portbench.harness import graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "graphormer.attention")
    if seconds is None:
        return None
    return 100.0 * seconds / r.counters["window_s"]
