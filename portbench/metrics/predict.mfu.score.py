"""The scoring window's share of the chip's peak: the forward FLOPs of
the molecules scored (at the model's padded shape, from
``harness/flops.py``) over the window and the configuration's peak."""

from portbench.harness import flops


def read(r):
    window = r.counters.get("window_s")
    if not window or not r.counters.get("scored"):
        return None
    per_row = flops.forward_flops_per_row(r.config["model"],
                                          r.config["budget"][0])
    peak = flops.PEAK_FLOPS["bfloat16" if r.config["numerics"] == "bf16"
                            else "float32"]
    return 100.0 * per_row * r.counters["scored"] / window / peak
