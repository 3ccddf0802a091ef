"""Device ms a beam step of the work launched inside the program's span
``beam.select``: log-softmax, top-k, the bookkeeping and the ancestry
gather."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "beam.select", "beam.step")
