"""GraphGPS's gated message passing against its byte bound: the least time
of the message work of the untraced window's train steps (forward and
backward) and validation batches (forward), every layer, over the device
seconds of the ``gps.message`` span (``ops/gated_message.py``) in those
units.

The least work is one pass each way at the configuration's padded shape
(``budget``: N atom rows and E edge slots a molecule, width
``hidden_size``, the compute dtype's bytes an element): forward, read
``dh``, ``eh``, ``bh`` and ``ce`` and write ``agg`` and ``e`` (4 node and
2 edge tensors); backward, read the two outputs' gradients, ``dh``,
``eh``, ``bh`` and ``ce`` and write their four gradients (7 node and 3
edge tensors); bytes at the HBM's rate.  The count is a lower bound and
the span also covers the host's gaps between its launches, so the reading
stays under 100%.  Nothing where the program opens no such span."""

from portbench.harness import graphormer_spans
from portbench.harness.flops import HBM_BYTES_PER_S

WIDTH = {"bf16": 2, "f32": 4}


def least_s(model, budget, numerics, train_rows, eval_rows):
    """Least seconds of the message work of ``train_rows`` training rows
    (forward and backward) and ``eval_rows`` evaluated rows (forward) in
    every layer."""
    n, e = budget
    row = model["hidden_size"] * WIDTH[numerics]
    fwd = (4 * n + 2 * e) * row
    bwd = (7 * n + 3 * e) * row
    return model["num_hidden_layers"] * (
        train_rows * (fwd + bwd) + eval_rows * fwd) / HBM_BYTES_PER_S


def read(r):
    seconds = graphormer_spans.device_seconds(r, "gps.message")
    if not seconds:
        return None
    least = least_s(r.config["model"], r.config["budget"],
                    r.config["numerics"], r.counters["train_rows"],
                    r.counters["eval_rows"])
    return 100.0 * least / seconds
