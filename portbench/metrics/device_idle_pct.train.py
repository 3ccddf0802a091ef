"""The share of a call's wall time, as the window paces it, in which no
kernel ran on the device (``readers.idle_pct``)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
