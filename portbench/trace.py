"""The traced slice: host ranges around the program's functions, the
profiler's Chrome trace, and the arithmetic that reads it.

The row arithmetic is a copy of ``imagecaptioner_tpu_torch/core/profiling.py``
(``trace_rows``, ``busy_share``, ``launched_within``), frozen here so that
the yardstick does not move with the program: a kernel is a device event of
category ``kernel``, a copy or fill ``gpu_memcpy`` / ``gpu_memset``, and a
``record_function`` range is no device work of its own.  Device work belongs
to a host range when its launch (a ``cuda_runtime`` or ``cuda_driver``
event) lies inside the range; the device event is found by the launch's
correlation id, never by the kernel's name.

A traced run makes two slices: one with host and device activity, for
the host ranges and what they launched, and one with device activity
alone, for the device's busy and idle time: the host activity's own cost
(every operator recorded) would otherwise read as idle time.

The trace is written under ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
PREFIX = "portbench:"


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    covered, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return covered


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _resolve(target: str):
    """``"package.module:Class.attr"`` -> (owner object, attribute name)."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


@contextlib.contextmanager
def host_ranges(targets: Sequence[str]):
    """Wrap each named function in a ``record_function`` range named
    ``portbench:<target>`` for the duration of the block."""
    import torch
    saved = []
    try:
        for target in dict.fromkeys(targets):
            owner, attr = _resolve(target)
            fn = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            label = PREFIX + target

            def make(f, label=label):
                @functools.wraps(f)
                def wrapped(*args, **kwargs):
                    with torch.profiler.record_function(label):
                        return f(*args, **kwargs)
                return wrapped
            new = staticmethod(make(fn.__func__)) \
                if isinstance(fn, staticmethod) else make(fn)
            saved.append((owner, attr, fn))
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


class Trace:
    """The events of one traced slice of ``calls`` timed units over
    ``wall_s`` host seconds."""

    def __init__(self, events: List[dict], calls: int, wall_s: float,
                 trace_bytes: int):
        self.events = events
        self.calls = calls
        self.wall_s = wall_s
        self.trace_bytes = trace_bytes
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS]
        self._launch_ts = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                self._launch_ts[e["args"]["correlation"]] = float(e["ts"])

    def busy_s(self, cats: Sequence[str] = DEVICE_CATS) -> float:
        """Seconds in which a device event of ``cats`` (by default a kernel,
        copy or fill) ran on the device."""
        return union_us((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                        for e in self.device if e.get("cat") in cats) / 1e6

    def host_spans(self, match: Callable[[str], bool]) -> List[Tuple[float, float]]:
        return merged((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                      for e in self.events if e.get("ph") == "X"
                      and e.get("cat") in HOST_CATS
                      and match(e.get("name", "")))

    def within(self, targets: Sequence[str] = (), ops: Sequence[str] = (),
               cats: Sequence[str] = DEVICE_CATS) -> Dict[str, float]:
        """Device work launched inside the host ranges placed around
        ``targets`` (``host_ranges``) or inside host operations whose name
        holds one of ``ops`` (autograd nodes): ``device_s`` summed over
        events, ``busy_s`` their union, ``events`` their count, ``spans``
        the merged host ranges."""
        labels = {PREFIX + t for t in targets}
        spans = self.host_spans(
            lambda n: n in labels or any(o in n for o in ops))
        starts = [a for a, _ in spans]

        def inside(ts: float) -> bool:
            i = bisect.bisect_right(starts, ts) - 1
            return i >= 0 and ts <= spans[i][1]

        picked = [e for e in self.device if e.get("cat") in cats
                  and inside(self._launch_ts.get(
                      e.get("args", {}).get("correlation"), float("-inf")))]
        iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in picked]
        return {"device_s": sum(b - a for a, b in iv) / 1e6,
                "busy_s": union_us(iv) / 1e6, "events": len(picked),
                "spans": len(spans)}

    def copies(self, kind: str) -> Dict[str, float]:
        """Copies whose kind (``args.kind`` or the name) holds ``kind``,
        e.g. ``HtoD``."""
        iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in self.device if e.get("cat") == "gpu_memcpy"
              and kind in (str(e.get("name", "")) + str(e.get("args", {})))]
        return {"device_s": sum(b - a for a, b in iv) / 1e6,
                "events": len(iv)}

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The ``n`` device operations that took most time, and the ``n``
        longest idle stretches summed by what the host was doing: the
        innermost host range open at the gap's middle."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            by_name[e.get("name", "?")[:120]] += float(e.get("dur", 0)) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = merged((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                      for e in self.device)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                        e.get("name", "?"))
                       for e in self.events if e.get("ph") == "X"
                       and e.get("cat") in HOST_CATS), key=lambda h: h[0])
        hstarts = [h[0] for h in host]
        by_host: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            label = "no host range"
            # ranges nest, so the latest-starting one that covers the
            # middle is the innermost
            j = bisect.bisect_right(hstarts, mid) - 1
            for j in range(j, max(j - 5000, -1), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            by_host[label[:120]] += (b - a) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def traced(run_units: Callable[[], Tuple[int, float]],
           host: bool = True) -> Trace:
    """Run ``run_units()`` (returns ``(calls, wall seconds)``) under the
    profiler, with host activity or without, write its trace under
    ``TMPDIR``, read it and delete it."""
    import torch
    act = [torch.profiler.ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():   # the CPU tests' device
        act.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=act) as prof:
        calls, wall = run_units()
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events, calls, wall, size)
