"""Per-step metric log of the trainers (``imagecaptioner_tpu/utils/logging.py``):
one JSON record a line, ``{"t", "epoch", "step", <metrics>[, "lr"]}``, with
``t`` the seconds since the logger was made.  Without a path it logs
nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, *,
                 print_every: int = 50):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self.start = time.time()

    def log_step(self, step: int, metrics: Dict, *, epoch: int = 0,
                 lr: Optional[float] = None) -> None:
        rec = {"t": round(time.time() - self.start, 3), "epoch": epoch,
               "step": step, **{k: float(v) for k, v in metrics.items()}}
        if lr is not None:
            rec["lr"] = float(lr)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
