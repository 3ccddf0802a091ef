"""Device ms a step of the work launched inside the program's span
``kd.feed``: the host batch's copies to the card."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "kd.feed", "kd.step")
