"""The 95th percentile of every call of the window, from the call to the
tokens on the host."""

from portbench.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95.0)
