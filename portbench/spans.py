"""Readers of the program's own spans: the ``ic:`` ranges that
``imagecaptioner_tpu_torch/core/spans.py`` opens at the port's layer
boundaries while a profiler records.

A span is counted as the trace events of exactly its name, one an entered
range, so that neighbouring ranges never merge into one.  Device work is
given to a span as ``Trace.within`` gives it to any host range: by its
launch's time, whatever thread launched it (autograd's device thread
launches the backward while the calling thread waits inside
``kd.backward``).  A program without the spans (an older commit) has
nothing to read here: every reader returns None.
"""

from __future__ import annotations

from typing import Optional

PREFIX = "ic:"


def count(trace, name: str) -> int:
    """Entered ranges of the span ``name`` in the traced slice."""
    label = PREFIX + name
    return sum(1 for e in trace.events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == label)


def launched_per(run, name: str, per: str, key: str) -> Optional[float]:
    """``Trace.within``'s ``key`` (``events``: device operations launched;
    ``busy_s``: their device seconds, a union) for the work launched inside
    the span ``name``, over the entered ranges of the span ``per``; None
    without a trace, without either span or without device work."""
    if run.trace is None:
        return None
    n = count(run.trace, per)
    if not n or not count(run.trace, name):
        return None
    work = run.trace.within(ops=[PREFIX + name])
    if not work["events"]:
        return None
    return work[key] / n


def launches(run, name: str, per: str) -> Optional[float]:
    """Device operations (kernels, copies, fills) launched inside ``name``,
    a ``per``."""
    return launched_per(run, name, per, "events")


def device_ms(run, name: str, per: str) -> Optional[float]:
    """Device ms (union) of the work launched inside ``name``, a ``per``."""
    s = launched_per(run, name, per, "busy_s")
    return None if s is None else 1e3 * s
