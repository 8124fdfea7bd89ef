"""GraphGPS's attention, without a bias, against its roofline: the least
time of the attention work of the untraced window's train steps (forward
and backward, with the dropout's keep-mask) and validation batches
(forward), every layer, from ``harness/flops_gps.py`` (no bias read and
no bias gradient written; operations at the compute dtype's peak or bytes
at the HBM's rate, the larger), over the device seconds of the
``graphormer.attention`` span in those units.  The span covers the host's
gaps between the attention's launches too."""

from portbench.harness import flops_gps, graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "graphormer.attention")
    if not seconds:
        return None
    least = flops_gps.attention_least_s(
        r.config["model"], r.config["budget"][0], r.config["numerics"],
        r.counters["train_rows"], r.counters["eval_rows"])
    return 100.0 * least / seconds
