"""Device operations launched a beam step inside the program's span
``beam.step``: the decoder step (#9, #10) and the selection."""

from portbench.spans import launches


def read(run):
    return launches(run, "beam.step", "beam.step")
