"""Share of the untraced training window that the device spends in EGT's
pair stream: the ``egt.pair`` device span (``models/layers.py::
EGTLayer``: the pair norm, the ``E`` and ``G`` projections, and the pair
update after the attention, its projection, FFN and residuals; forward,
and backward between tensor hooks) summed over the ``train_epoch`` and
``evaluate`` units of ``utils/telemetry.py`` that closed after the newest
profiled ones, over the window.  Nothing where their number is not the
window's epochs, or the program opens no such span."""

from portbench.harness import graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "egt.pair")
    if seconds is None:
        return None
    return 100.0 * seconds / r.counters["window_s"]
