"""Idle share of the device over the traced window: 1 - (the union of
kernel, copy and set intervals) / the traced window."""

from portbench.harness.readers import idle_share


def read(r):
    return idle_share(r)
