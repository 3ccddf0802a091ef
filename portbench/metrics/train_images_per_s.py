"""Images trained on (every micro-batch of every step) in the window over
its seconds, the last step's work finished."""

from portbench.readers import rate


def read(run):
    return rate(run)
