"""Share of the untraced training window that the device spends building
the graph transformer's structural attention bias: the
``graphormer.bias`` device span (``models/zoo.py::GraphormerNet``,
forward only), summed as ``graphormer.attention_share.train`` sums its
span."""

from portbench.harness import graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "graphormer.bias")
    if seconds is None:
        return None
    return 100.0 * seconds / r.counters["window_s"]
