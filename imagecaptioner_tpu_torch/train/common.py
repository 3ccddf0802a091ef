"""Shared trainer plumbing (``imagecaptioner_tpu/train/common.py``):
accumulation stacking, per-step metric lists, early stopping, history,
progress lines, a wall-clock timer.  The mesh helpers belong to multi-GPU
(ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES


def data_parallel_over_cards(data_parallel: bool, device) -> bool:
    """Whether a trainer asked for data parallelism on a CUDA device with
    several cards visible: not ported yet (item 13).  On one device it is a
    no-op, as the reference's ``maybe_mesh`` makes it; a CPU run has one
    device."""
    return (data_parallel and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1)


def flatten_step_metrics(fetched: List[Dict]) -> List[Dict]:
    """One flat per-step list from a mix of per-step metric dicts (scalars)
    and stacked ones ((k,) arrays, k steps of one chained dispatch)."""
    out: List[Dict] = []
    for m in fetched:
        v0 = next(iter(m.values()))
        if np.ndim(v0) == 1:
            out.extend({k: v[i] for k, v in m.items()}
                       for i in range(len(v0)))
        else:
            out.append(m)
    return out


def fetch_step_metrics(step_metrics: List[Dict[str, torch.Tensor]]
                       ) -> List[Dict[str, float]]:
    """The epoch's one host fetch: per-step dicts of 0-d tensors and chained
    dicts of (k,) tensors -> one flat list of per-step float dicts."""
    return [{k: float(v) for k, v in m.items()}
            for m in flatten_step_metrics(
                [{k: v.cpu().numpy() for k, v in m.items()}
                 for m in step_metrics])]


def stacked_batches(loader, accumulation_steps: int) -> Iterator[Dict]:
    """Group loader batches into stacks of ``A`` for in-step accumulation.
    A trailing incomplete group is dropped: the reference only steps the
    optimizer on accumulation boundaries."""
    buf: List[Dict] = []
    for batch in loader:
        buf.append(batch)
        if len(buf) == accumulation_steps:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            buf = []


class EarlyStopping:
    """Best-value tracking + patience (mode='min' for loss, 'max' for BLEU)."""

    def __init__(self, patience: int, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0

    def update(self, value: float) -> bool:
        """Returns True if ``value`` is a new best."""
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best)
                    or (self.mode == "max" and value > self.best))
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience


def write_history(path: str, history: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(history, f, indent=2)


def log_progress(epoch, batch_idx, loss_dict, learning_rate, total_batches):
    print(f"Epoch {epoch}, Batch {batch_idx}/{total_batches}")
    print(f"  LR: {learning_rate:.6f}")
    for name in LOSS_NAMES:
        if name in loss_dict:
            label = name.replace("_", " ").title()
            print(f"  {label}: {float(loss_dict[name]):.4f}")
    print("-" * 50)


class Timer:
    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start
