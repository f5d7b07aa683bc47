"""Percent of the traced window in which no operation ran on the device
(torch.profiler)."""

from portbench.trace import idle_share


def read(rec):
    return idle_share(rec)
