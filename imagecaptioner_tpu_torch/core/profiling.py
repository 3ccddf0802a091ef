"""Per-kernel device time from ``torch.profiler``
(``imagecaptioner_tpu/core/profiling.py``).

``profile_device`` runs a callable under the profiler with its CUDA
activity on, exports the Chrome trace and keeps one row per device event:

  * a kernel (``cat == "kernel"``) is a row of its kind (``kind_of``);
  * a copy (``gpu_memcpy``) or a fill (``gpu_memset``) is a row of the kind
    "copies (memcpy)" or "copies (memset)";
  * a ``record_function`` range (``user_annotation`` on the host,
    ``gpu_user_annotation`` on the device) is no row: its device span covers
    the kernels launched inside it, so counting it counts them twice.

Besides the rows, the result holds the traced window's span on the device
(first device event's start to last one's end) and the card's **busy
share** of it: the union of the kernels' intervals over the span, which
cannot exceed 1.  ``aggregate`` and ``top_table`` are the JAX module's, with
``by_kind`` in place of the XLA ``by_category``.

``KINDS`` names the hand-written kernels #1-#12 of this package
(``csrc/*.cu``) each as a kind of its own and sorts the library kernels into
a few more; the profile scripts (``scripts/torch_profile_*.py``) share it.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["KINDS", "OTHER", "kind_of", "trace_rows", "load_trace_events",
           "profiler_events", "profile_device", "launched_within",
           "aggregate", "top_table", "busy_share"]

# kernel-name fragments (lower case) -> kind, first match wins
KINDS = [
    ("#11 int8 products", ("int8_gemm_kernel", "int8_depthwise_kernel")),
    ("#12 int8 quantization", ("int8_amax_kernel", "int8_quantize_kernel")),
    ("#3 compact greedy decode", ("greedy_compact_kernel",)),
    ("#1 greedy decode", ("greedy_kernel",)),
    ("#9 beam self-attention", ("beam_self_kernel",)),
    ("#10 beam cross-attention", ("beam_cross_kernel",)),
    ("#2 attention core", ("attention_kernel",)),
    ("#7 compact scan", ("compact_scan_kernel",)),
    ("#8 enhanced scan", ("enhanced_scan_kernel",)),
    # csrc/decoder_scan_bwd.cu: the recompute (prep, gemm), the cooperative
    # reverse chain and the post-loop reductions; then the weight gradients
    ("#6 decoder scan backward (recompute, chain, reductions)",
     ("prep_kernel", "::gemm_kernel", "chain_kernel", "post_kernel")),
    ("#6 decoder scan backward (weight gradients)",
     ("weight_grad_kernel", "bias_grad_kernel")),
    ("#4/#5 decoder scan forward", ("scan_kernel",)),
    ("copies (memcpy)", ("memcpy",)),
    ("copies (memset)", ("memset",)),
    ("top-k and sorts", ("topk", "sort", "radix", "bitonic")),
    ("softmax and log-softmax", ("softmax",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bnorm")),
    ("convolution (cuDNN)", ("cudnn", "conv", "wgrad", "dgrad", "fprop",
                             "implicit", "winograd", "nchw", "nhwc")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "cublas",
                                  "xmma")),
]
OTHER = "elementwise, reductions, optimizer, other"

# Chrome-trace categories of the device events that are rows
_COPY_KIND = {"gpu_memcpy": "copies (memcpy)", "gpu_memset": "copies (memset)"}


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f in low for f in frags):
            return kind
    return OTHER


def load_trace_events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def profiler_events(prof, trace_path: Optional[str] = None) -> List[dict]:
    """The Chrome-trace events of a finished ``torch.profiler.profile``;
    ``trace_path`` keeps the trace file."""
    path = trace_path
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="ic_trace_")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_trace_events(path)
    finally:
        if trace_path is None:
            os.remove(path)


def busy_share(intervals: Sequence[tuple], span: float) -> float:
    """The union of ``(start, end)`` intervals over ``span`` (<= 1)."""
    if span <= 0:
        return 0.0
    covered, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return covered / span


def trace_rows(events: Sequence[dict], runs: int = 1) -> Dict[str, Any]:
    """Rows of the device events of a Chrome trace (module docstring), the
    span of the window, the kernels' busy share, and the aggregates."""
    rows, kernels = [], []
    first, last = float("inf"), float("-inf")
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or (cat != "kernel" and cat not in _COPY_KIND):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        first, last = min(first, ts), max(last, ts + dur)
        args = e.get("args", {})
        kind = kind_of(e.get("name", "")) if cat == "kernel" \
            else _COPY_KIND[cat]
        if cat == "kernel":
            kernels.append((ts, ts + dur))
        rows.append({"name": e.get("name", ""), "dur_us": dur,
                     "bytes": int(args.get("bytes", 0) or 0), "flops": 0,
                     "category": kind, "kind": kind, "tf_op": "",
                     "ts_us": ts})
    span = max(last - first, 0.0) if rows else 0.0
    return {"rows": rows, "runs": runs,
            "span_us_per_run": span / max(runs, 1),
            "kernel_us_per_run": sum(b - a for a, b in kernels)
            / max(runs, 1),
            "device_us_per_run": sum(r["dur_us"] for r in rows)
            / max(runs, 1),
            "launches_per_run": len(kernels) / max(runs, 1),
            "busy_share": busy_share(kernels, span),
            "by_name": aggregate(rows, "name", runs),
            "by_kind": aggregate(rows, "kind", runs)}


def launched_within(events: Sequence[dict], match: Callable[[str], bool],
                    runs: int = 1) -> Dict[str, Any]:
    """``trace_rows`` of the device events launched from inside the host
    ranges (``record_function`` ranges, autograd nodes) whose name
    ``match`` accepts: a launch belongs to a range when its runtime call
    lies inside one of the range's host spans, and its device event is
    found by the launch's correlation id.  ``spans_per_run`` counts the
    ranges."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("user_annotation", "cpu_op")
                   and match(e.get("name", "")))
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})
              and any(a <= float(e["ts"]) <= b for a, b in spans)}
    out = trace_rows([e for e in events
                      if e.get("cat") in ("kernel", *_COPY_KIND)
                      and e.get("args", {}).get("correlation") in inside],
                     runs)
    out["spans_per_run"] = len(spans) / max(runs, 1)
    return out


def profile_device(fn: Callable[[Any], Any], make_input: Callable[[int], Any],
                   *, runs: int = 3, warmup: int = 1,
                   trace_path: Optional[str] = None) -> Dict[str, Any]:
    """Run ``fn(make_input(i))`` ``runs`` times under ``torch.profiler``
    (CPU and CUDA activities) and return ``trace_rows`` of its trace.

    ``warmup`` untraced calls run first.  The inputs are built, and the
    card drained, before the trace opens, so that no upload or
    initialisation ``make_input`` does is charged to ``fn``.  Each traced
    call ends in a host fetch of a scalar of every output
    (``core/timing.sync``).  ``trace_path`` keeps the Chrome trace."""
    import torch

    from imagecaptioner_tpu_torch.core.timing import sync

    for i in range(warmup):
        sync([fn(make_input(1000 + i))])
    inputs = [make_input(2000 + i) for i in range(runs)]
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for x in inputs:
            sync([fn(x)])
    out = trace_rows(profiler_events(prof, trace_path), runs)
    out["trace_path"] = trace_path
    return out


def aggregate(rows: Sequence[dict], key: str, runs: int = 1) -> List[dict]:
    """Sum device time (per traced run) grouped by ``key``, descending."""
    acc: Dict[str, dict] = collections.defaultdict(
        lambda: {"dur_us": 0.0, "bytes": 0, "flops": 0, "count": 0})
    meta: Dict[str, dict] = {}
    for r in rows:
        a = acc[r[key]]
        a["dur_us"] += r["dur_us"]
        a["bytes"] += r["bytes"]
        a["flops"] += r["flops"]
        a["count"] += 1
        meta.setdefault(r[key], r)
    out = []
    for k, a in acc.items():
        out.append({
            key: k,
            "dur_us_per_run": a["dur_us"] / max(runs, 1),
            "count_per_run": a["count"] / max(runs, 1),
            "gbytes_per_s": (a["bytes"] / 1e9) / (a["dur_us"] / 1e6)
            if a["dur_us"] else 0.0,
            "tflops_per_s": (a["flops"] / 1e12) / (a["dur_us"] / 1e6)
            if a["dur_us"] else 0.0,
            "category": meta[k].get("category", "?"),
            "tf_op": meta[k].get("tf_op", "")[:120],
        })
    out.sort(key=lambda d: -d["dur_us_per_run"])
    return out


def top_table(agg: Sequence[dict], key: str, n: int = 25,
              total_us: Optional[float] = None) -> str:
    total = total_us or sum(d["dur_us_per_run"] for d in agg)
    lines = [f"{'us/run':>10} {'%':>5} {'GB/s':>7} {'TF/s':>6}  {key}"]
    for d in list(agg)[:n]:
        lines.append(
            f"{d['dur_us_per_run']:10.1f} {100*d['dur_us_per_run']/total:5.1f}"
            f" {d['gbytes_per_s']:7.1f} {d['tflops_per_s']:6.2f}"
            f"  {d[key][:60]}  [{d['category']}]")
    lines.append(f"{total:10.1f} 100.0                 TOTAL device time")
    return "\n".join(lines)
