"""Device ms a call of the host-to-device copies (the uint8 batch the
captioner uploads)."""


def read(run):
    if run.trace is None:
        return None
    c = run.trace.copies("HtoD")
    return 1e3 * c["device_s"] / run.trace.calls if c["events"] else None
