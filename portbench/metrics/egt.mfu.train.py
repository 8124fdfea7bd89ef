"""EGT's training window's share of the chip's peak: the FLOPs of its
train steps (three forward passes a row) and validation batches (one),
from ``harness/flops_egt.py`` at the padded shape (the atoms' slots, the
virtual nodes and every pair slot), over the untraced window and the peak
of the configuration's compute dtype: ``gps.mfu.train``'s rule."""

from portbench.harness import flops, flops_egt


def read(r):
    window = r.counters.get("window_s")
    if not window or not r.counters.get("epochs"):
        return None
    per_row = flops_egt.forward_flops_per_row(r.config["model"],
                                              r.config["budget"][0])
    rows = 3 * r.counters["train_rows"] + r.counters["eval_rows"]
    peak = flops.PEAK_FLOPS["bfloat16" if r.config["numerics"] == "bf16"
                            else "float32"]
    return 100.0 * per_row * rows / window / peak
