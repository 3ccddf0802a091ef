"""Device ms a step of the work launched inside the program's span
``kd.backward``: the student's and the projectors' backward (#6 included),
every micro-batch."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "kd.backward", "kd.step")
