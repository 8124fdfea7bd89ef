"""Kernel 1's share of its roofline: the least time of the adjacency work
of the traced batches (``harness/flops.py``) over the device time of the
kernel in the trace."""

from portbench.harness.readers import roofline


def read(r):
    return roofline(r, "adjacency", "dense_adjacency_kernel", "forward")
