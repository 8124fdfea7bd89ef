"""Share of the untraced training window that the device spends in EGT's
gated attention: the ``egt.attention`` device span
(``ops/biased_attention.py::GatedAttention``, forward and backward, each
layer) summed over the ``train_epoch`` and ``evaluate`` units of
``utils/telemetry.py`` that closed after the newest profiled ones, over
the window.  Nothing where their number is not the window's epochs, or
the program opens no such span."""

from portbench.harness import graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "egt.attention")
    if seconds is None:
        return None
    return 100.0 * seconds / r.counters["window_s"]
