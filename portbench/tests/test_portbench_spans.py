"""The readers of the program's spans (``portbench/spans.py`` and the five
metrics that use it): exact on a trace made by hand, None where the program
has no spans, a number or None on tiny traced CPU runs of every cell, whose
traced slice holds the spans, and on the card a value in every traced run,
with the program's ``serve.encode`` holding what the benchmark's own range
around ``Student.encode_image`` launched."""

import bisect
import math
import types

import pytest

from portbench import harness, spec
from portbench import spans as SP
from portbench import trace as TR

NEW = {"full_greedy_b256": ["encode_launches_call.greedy"],
       "teacher_beam_b512": ["beam_launches_step.beam",
                             "beam_select_ms_step.beam"],
       "full_kd_a2b64": ["feed_ms.train", "student_backward_ms.train"]}
ENCODE = "imagecaptioner_tpu_torch.models.student:Student.encode_image"


def _reader(name):
    return spec.metric_reader(name).read


def _host(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(corr, a, b, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": a, "dur": b - a,
            "args": {"correlation": corr}}


def _made_trace():
    """Two calls and two KD steps by hand.  Call 1 launches two operations
    in ``serve.encode`` and one after it; call 2 one in ``serve.encode``.
    Two ``beam.step`` ranges touch end to end (one merged interval, two
    steps); the first's ``beam.select`` launches one kernel.  Each step's
    ``kd.feed`` launches one copy, each ``kd.backward`` a kernel, the
    first two, whose device times overlap (a union of 30 µs, not 40)."""
    ev = [_host("ic:serve.call", 0, 100), _host("ic:serve.encode", 10, 50),
          _host("ic:serve.call", 100, 200), _host("ic:serve.encode", 110, 150),
          _launch(1, 20), _launch(2, 30), _launch(3, 60), _launch(4, 120),
          _kernel(1, 1000, 1010), _kernel(2, 1005, 1020),
          _kernel(3, 1020, 1030), _kernel(4, 1040, 1044),
          _host("ic:beam.step", 300, 310), _host("ic:beam.step", 310, 320),
          _host("ic:beam.select", 305, 309), _launch(5, 306),
          _launch(6, 315), _kernel(5, 1100, 1106), _kernel(6, 1110, 1111),
          _host("ic:kd.feed", 400, 410), _host("ic:kd.step", 410, 500),
          _host("ic:kd.backward", 450, 490),
          _host("ic:kd.feed", 500, 510), _host("ic:kd.step", 510, 600),
          _host("ic:kd.backward", 550, 590),
          _launch(7, 405), _launch(8, 460), _launch(9, 505), _launch(10, 560),
          _launch(11, 470), _kernel(11, 1220, 1235),
          _kernel(7, 1200, 1210, "gpu_memcpy"), _kernel(8, 1205, 1230),
          _kernel(9, 1300, 1302, "gpu_memcpy"), _kernel(10, 1310, 1320)]
    return TR.Trace(ev, calls=2, wall_s=1.0, trace_bytes=0)


def test_readers_on_a_made_trace():
    run = types.SimpleNamespace(trace=_made_trace())
    assert SP.count(run.trace, "beam.step") == 2
    assert run.trace.within(ops=["ic:beam.step"])["spans"] == 1
    got = {n: _reader(n)(run) for names in NEW.values() for n in names}
    assert got == pytest.approx({
        "encode_launches_call.greedy": 3 / 2,
        "beam_launches_step.beam": 2 / 2,
        "beam_select_ms_step.beam": 6e-3 / 2,
        "feed_ms.train": (10 + 2) * 1e-3 / 2,
        "student_backward_ms.train": (30 + 10) * 1e-3 / 2})


def test_readers_without_the_programs_spans():
    """The parent's trace (ranges of the benchmark's own, no ``ic:`` span)
    and a run without a trace: nothing to read."""
    t = _made_trace()
    old = TR.Trace([dict(e, name=e["name"].replace("ic:", "portbench:"))
                    for e in t.events], 2, 1.0, 0)
    for trace in (old, None):
        run = types.SimpleNamespace(trace=trace)
        for names in NEW.values():
            for n in names:
                assert _reader(n)(run) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_new_readers_on_tiny_cpu_runs(cell, tiny, monkeypatch):
    """The spans reach the harness's traced slice on the CPU; every new
    reader returns a number or None there (the CPU launches no device
    work) and the run's line holds no other value for them."""
    traces = []
    real = TR.traced

    def keep(*a, **k):
        traces.append(real(*a, **k))
        return traces[-1]
    monkeypatch.setattr(TR, "traced", keep)
    out = harness.run_cell(cell, 2**31 + 31, 0.1, True, device="cpu",
                           log=lambda s: None, **tiny(cell))
    assert out["correct"], out["check"]
    host = traces[0]
    calls = host.calls
    if cell == "full_kd_a2b64":
        A = harness.make_context(cell, 0, "cpu", **tiny(cell)
                                 ).traffic["accumulation"]
        assert SP.count(host, "kd.step") == SP.count(host, "kd.feed") == calls
        assert SP.count(host, "kd.backward") == A * calls
    else:
        for name in ("serve.call", "serve.encode", "serve.decode"):
            assert SP.count(host, name) == calls
        if cell == "teacher_beam_b512":
            assert SP.count(host, "beam.step") >= calls
    run = types.SimpleNamespace(trace=host)
    for name in NEW[cell]:
        v = _reader(name)(run)
        assert v is None or math.isfinite(v)
        assert name not in out["metrics"] or v is not None


def _launched(trace, match):
    """Correlation ids of the device work launched inside the host ranges
    whose name ``match`` accepts."""
    spans = trace.host_spans(match)
    starts = [a for a, _ in spans]
    ids = set()
    for e in trace.device:
        corr = e.get("args", {}).get("correlation")
        ts = trace._launch_ts.get(corr)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            ids.add(corr)
    return ids


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(NEW))
def test_new_metrics_read_on_the_card(cell, card, monkeypatch):
    """Each new metric has a value in its cell's traced run; in the greedy
    run the operations launched inside the benchmark's range around
    ``Student.encode_image`` are all inside the program's ``serve.encode``,
    which adds the normalization's few: the two agree on one clock."""
    traces = []
    real = TR.traced

    def keep(*a, **k):
        traces.append(real(*a, **k))
        return traces[-1]
    monkeypatch.setattr(TR, "traced", keep)
    out = harness.run_cell(cell, 3000000041, 2.0, True, log=lambda s: None)
    assert out["correct"], out["check"]
    for name in NEW[cell]:
        assert name in out["metrics"], sorted(out["metrics"])
        assert out["metrics"][name]["value"] > 0
    if cell == "full_greedy_b256":
        host = traces[0]
        ours = _launched(host, lambda n: n == "ic:serve.encode")
        theirs = _launched(host, lambda n: n == TR.PREFIX + ENCODE)
        assert theirs and theirs <= ours
        extra = (len(ours) - len(theirs)) / host.calls
        assert 1 <= extra <= 8, extra
