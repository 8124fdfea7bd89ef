"""EGT's gated attention against its roofline: the least time of the
gated attention's work in the untraced window's train steps (forward and
backward, with the dropout's keep-mask) and validation batches
(forward), every layer, from ``harness/flops_egt.py`` (each of ``q``,
``k``, ``v``, ``E``, ``G``, ``H^`` and the output, and their gradients,
moved once; operations at the compute dtype's peak or bytes at the HBM's
rate, the larger), over the device seconds of the ``egt.attention`` span
in those units.  The count is of the work, whatever implements it."""

from portbench.harness import flops_egt, graphormer_spans


def read(r):
    seconds = graphormer_spans.device_seconds(r, "egt.attention")
    if not seconds:
        return None
    least = flops_egt.attention_least_s(
        r.config["model"], r.config["budget"][0], r.config["numerics"],
        r.counters["train_rows"], r.counters["eval_rows"])
    return 100.0 * least / seconds
