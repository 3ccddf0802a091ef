"""Inference latency harness of the port (``imagecaptioner_tpu/eval/latency.py``).

Warm-up, then timed runs, each on its own input (``make_input(i)``) and
each ending when one element of every output tensor has been copied to the
host: the timed window holds the device work and the device-to-host
return, as a serving call does.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch


def _tensor_leaves(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensor_leaves(o)]
    return []


def sync(out: Any) -> None:
    """Copy one element of every output tensor to the host."""
    leaves = [t.reshape(-1)[:1].float() for t in _tensor_leaves(out)
              if t.numel()]
    if leaves:
        torch.cat(leaves).cpu()


def measure_inference_time(fn: Callable[[Any], Any],
                           make_input: Callable[[int], Any], *,
                           num_runs: int = 10,
                           warmup: int = 3) -> Dict[str, float]:
    """Per-call latency of ``fn(make_input(i))``: ``mean_s``, ``p50_s``,
    ``min_s``, ``max_s`` and ``num_runs``."""
    for i in range(warmup):
        sync(fn(make_input(1_000_000 + i)))
    times = []
    for i in range(num_runs):
        x = make_input(i)
        sync(x)                  # the input's own work stays out of the window
        t0 = time.perf_counter()
        sync(fn(x))
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    return {"mean_s": sum(times) / n, "p50_s": times[n // 2],
            "min_s": times[0], "max_s": times[-1], "num_runs": n}
