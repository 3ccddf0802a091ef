"""One run of one cell: set-up, the measured window, the optional traced
slices, the check against the plain reference, and the result line.

``run_cell`` does the work and returns the result; ``main`` adds the
command line, the look for the cards and the printing.  The tests call
``run_cell`` on the CPU with tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "imagecaptioner_tpu")


class Context:
    """What an entry's ``build`` gets: the seed, the device, the
    configuration (and any it names), the traffic mix, and a clock for the
    phases of set-up."""

    def __init__(self, bench: dict, cell: dict, config: dict, traffic: dict,
                 seed: int, device, configs: Dict[str, dict]):
        self.bench, self.cell, self.config, self.traffic = (
            bench, cell, config, traffic)
        self.seed, self.device, self.configs = seed, device, configs
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)


class Run:
    """What a metric reader reads: the cell object, its window and, in a
    traced run, its trace (host ranges and device work) and its device
    slice (device work alone: busy and idle time)."""

    def __init__(self, ctx: Context, unit, setup_s: float):
        self.ctx, self.unit, self.setup_s = ctx, unit, setup_s
        self.window: Dict[str, object] = {}
        self.trace = None
        self.device = None


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def run_window(unit, seconds: float) -> Dict[str, object]:
    """Call the unit back to back until ``seconds`` have passed, then let it
    finish what it queued.  Every call is timed from the call to its result
    on the host."""
    lat: List[float] = []
    items = 0
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        items += unit.call(len(lat))
        e = time.perf_counter()
        lat.append(e - s)
        if e - t0 >= seconds:
            break
    unit.finish()
    t1 = time.perf_counter()
    return {"seconds": t1 - t0, "calls": len(lat), "items": items,
            "latencies": lat}


def slice_targets(readers: Dict[str, object]) -> List[str]:
    out: List[str] = []
    for r in readers.values():
        out.extend(getattr(r, "WRAP", ()))
    return out


def make_context(name: str, seed: int, device: str = "cuda", *,
                 bench: Optional[dict] = None,
                 config_over: Optional[Dict[str, dict]] = None,
                 traffic_over: Optional[dict] = None,
                 root: Optional[Path] = None) -> Context:
    """The cell's configuration (and the one it names under
    ``teacher_config``) and traffic mix, found by name (traffic mixes under
    ``root``, by default ``portbench/``); ``config_over`` and
    ``traffic_over`` replace entries of them (the CPU tests' tiny sizes).
    Turns TF32 off: every configuration here states float32 or bf16."""
    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, name)

    def conf(n):
        c = spec.config(bench, n)
        for k, v in (config_over or {}).get(n, {}).items():
            c[k] = {**c[k], **v} if isinstance(v, dict) else v
        return c
    config = conf(cell["config"])
    configs = {config["name"]: config}
    if config.get("teacher_config"):
        configs[config["teacher_config"]] = conf(config["teacher_config"])
    traffic = {**spec.traffic(cell["traffic"], root),
               **(traffic_over or {})}
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Context(bench, cell, config, traffic, seed, torch.device(device),
                   configs)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None,
             config_over: Optional[Dict[str, dict]] = None,
             traffic_over: Optional[dict] = None,
             root: Optional[Path] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                          flush=True)) -> dict:
    """Set up, (trace,) measure and check one cell; returns the result
    object."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or spec.load_benchmark()
    ctx = make_context(name, seed, device, bench=bench,
                       config_over=config_over, traffic_over=traffic_over,
                       root=root)
    cell, traffic, dev = ctx.cell, ctx.traffic, ctx.device
    kind = "per_layer" if trace else "end_to_end"
    readers = spec.readers(bench, name, kind, root)
    import torch
    ctx.phases["import"] = time.perf_counter() - t_start
    unit = spec.entry(traffic["entry"]).build(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.phases.items()))
    run = Run(ctx, unit, setup_s)
    run.window = run_window(unit, seconds)
    if trace:
        # after the window, so that the profiler's after-effects on the
        # host (a traced process runs slower) stay out of the window
        from portbench import trace as TR

        def units(k: int):
            def run_units():
                t0 = time.perf_counter()
                for i in range(k):
                    unit.call(i)
                unit.finish()
                return k, time.perf_counter() - t0
            return run_units
        with TR.host_ranges(slice_targets(readers)):
            run.trace = TR.traced(units(int(traffic.get("trace_calls", 3))))
        run.device = TR.traced(units(int(traffic.get(
            "device_calls", traffic.get("trace_calls", 3)))), host=False)
        for what, t in (("traced", run.trace), ("device slice", run.device)):
            log(f"{what}: {t.calls} calls in {t.wall_s:.3f} s, trace "
                f"{t.trace_bytes} bytes (deleted)")
    found = jax_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {found}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    metrics = {}
    for m in spec.metrics_of(bench, name, kind):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # a number with no limit is read, not compared (calibrate.py prints it)
    checks = {k: v for k, v in unit.check().items() if v[1] is not None}
    failed = int(getattr(unit, "failed", 0))
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.window["calls"],
           "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.device.busy_s()
        device_info["window_s"] = run.device.wall_s
        out["breakdown"] = run.trace.breakdown()
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'OVER'}")
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.get("chips", 1)):
        print(f"{args.workload} needs {cell.get('chips', 1)} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start, bench=bench)
    print(json.dumps(out), flush=True)
    return 0
