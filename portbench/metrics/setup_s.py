"""Set-up: process start to the first timed call (imports, kernels,
weights, the traffic pool, warm-up or the checked steps)."""


def read(run):
    return run.setup_s
