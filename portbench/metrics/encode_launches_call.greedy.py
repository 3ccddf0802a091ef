"""Device operations launched a call inside the program's span
``serve.encode``: the normalization, ResNet-50, the projection and the
refinement."""

from portbench.spans import launches


def read(run):
    return launches(run, "serve.encode", "serve.call")
