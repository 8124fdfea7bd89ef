"""GraphGPS's training window's share of the chip's peak: the FLOPs of
its train steps (three forward passes a row) and validation batches
(one), from ``harness/flops_gps.py`` at the padded shape (atoms and edge
slots), over the untraced window and the peak of the configuration's
compute dtype: ``graphormer.mfu.train``'s rule."""

from portbench.harness import flops, flops_gps


def read(r):
    window = r.counters.get("window_s")
    if not window or not r.counters.get("epochs"):
        return None
    n_nodes, n_edges = r.config["budget"]
    per_row = flops_gps.forward_flops_per_row(r.config["model"], n_nodes,
                                              n_edges)
    rows = 3 * r.counters["train_rows"] + r.counters["eval_rows"]
    peak = flops.PEAK_FLOPS["bfloat16" if r.config["numerics"] == "bf16"
                            else "float32"]
    return 100.0 * per_row * rows / window / peak
