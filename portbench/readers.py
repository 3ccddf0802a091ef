"""Arithmetic shared by the metric readers of ``portbench/metrics/``.

A reader returns a number or None (nothing to read: no trace, no device
time in its ranges); the harness leaves a None out of the result line.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from portbench.work import peaks


def rate(run) -> float:
    """Items completed in the window over its seconds."""
    return run.window["items"] / run.window["seconds"]


def percentile_ms(run, q: float) -> float:
    return float(np.percentile(run.window["latencies"], q)) * 1e3


def span_device_s(run, targets: Sequence[str] = (),
                  ops: Sequence[str] = ()) -> Optional[float]:
    """Device seconds (union) of the work launched in the traced slice
    from inside the host ranges around ``targets`` or host operations
    named with one of ``ops``; None without a trace or work."""
    if run.trace is None:
        return None
    s = run.trace.within(targets, ops)["busy_s"]
    return s if s > 0 else None


def roofline_pct(run, flops: float, nbytes: float, dtype: str,
                 targets: Sequence[str] = (),
                 ops: Sequence[str] = ()) -> Optional[float]:
    """The least time of ``flops`` and ``nbytes`` (the traced slice's
    work) over the device time of the ranges, in percent."""
    t = span_device_s(run, targets, ops)
    if t is None:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes, dtype) / t


def per_call_ms(run, targets: Sequence[str] = (),
                ops: Sequence[str] = ()) -> Optional[float]:
    t = span_device_s(run, targets, ops)
    return None if t is None else 1e3 * t / run.trace.calls


def idle_pct(run) -> Optional[float]:
    """The share of a call's wall time in which no kernel ran on the
    device: the device slice's kernel seconds a call (device activity
    traced alone) over the window's seconds a call, so that the profiler's
    own cost on the host does not read as idle time.  Copies count as
    idle: a pageable upload's time follows the host's pace, and the
    uploads have a metric of their own."""
    if run.device is None or not run.device.calls or \
            not run.window.get("calls"):
        return None
    busy = run.device.busy_s(("kernel",)) / run.device.calls
    wall = run.window["seconds"] / run.window["calls"]
    return 100.0 * (1.0 - busy / wall)


def mfu_pct(run, flops_per_item: float) -> float:
    """Model operations of the items the window completed, over its
    seconds and the bf16 peak."""
    return 100.0 * rate(run) * flops_per_item / peaks.BF16_FLOPS
