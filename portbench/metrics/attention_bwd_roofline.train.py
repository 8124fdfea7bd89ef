"""Kernel 3's share of its roofline: the least time of the attention
backward work of the traced train steps over the kernel's device time."""

from portbench.harness.readers import roofline


def read(r):
    return roofline(r, "attention_bwd", "masked_attention_bwd_kernel",
                    "backward")
