"""Kernel 2's share of its roofline: the least time of the attention
forward work of the traced batches over the kernel's device time."""

from portbench.harness.readers import roofline


def read(r):
    return roofline(r, "attention_fwd", "masked_attention_kernel", "forward")
