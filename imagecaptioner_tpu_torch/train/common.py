"""Shared trainer plumbing (``imagecaptioner_tpu/train/common.py``):
accumulation stacking, per-step metric lists, early stopping, history,
progress lines, a wall-clock timer, and the data-parallel helpers.

Data parallelism (``core/mesh.py``, ``parallel/multihost.py``) runs one
process per card.  A trainer joins a world that the environment names
(``distributed_init_from_env``: ``IC_COORDINATOR``, ``IC_NUM_PROCESSES``,
``IC_PROCESS_ID``, as the JAX trainers read them) or that its caller made;
each process then loads its own rows (``host_shard``) and its loader's
batch is its block of the global batch.  With no world and several cards
visible, a trainer asked for data parallelism on ``cuda`` starts one
process per card itself (``cards_to_spawn``, ``run_per_card``): every rank
reads the same loader batches, which are the global batch, and takes its
contiguous block, as JAX's one process splits a batch over its devices.
``maybe_mesh`` keeps the JAX function's decisions and refusals.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.parallel import multihost as MH


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


def stacked_batches(loader, accumulation_steps: int, *, mesh=None,
                    prefetch: int = 2) -> Iterator[Dict]:
    """Group loader batches into stacks of ``A`` for in-step accumulation.
    A trailing incomplete group is dropped: the reference only steps the
    optimizer on accumulation boundaries.

    With a ``mesh`` each stack is this rank's part of the global batch on
    its card (``put_global_batch``), ``prefetch`` stacks ahead."""
    def gen():
        buf: List[Dict] = []
        for batch in loader:
            buf.append(batch)
            if len(buf) == accumulation_steps:
                yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                buf = []

    if mesh is None:
        yield from gen()
        return
    ahead = collections.deque()
    it = gen()
    for stk in it:
        ahead.append(put_global_batch(mesh, stk, stacked=True))
        if len(ahead) > prefetch:
            yield ahead.popleft()
    while ahead:
        yield ahead.popleft()


def put_global_batch(mesh, batch: Dict, *, stacked: bool = True) -> Dict:
    """This rank's part of a loader batch on its card: the batch itself
    when each process loads its own rows (its data index's), the
    contiguous block of the batch axis at its data index when the loaders'
    batches are global (``mesh.split``).
    ``stacked=True`` takes accumulation stacks with a leading (A, ...)
    axis (train), ``stacked=False`` one loader batch (eval)."""
    a = 1 if stacked else 0
    if mesh.split:
        batch = {k: MS.batch_block(v, mesh, a + 1 if k.startswith("captions")
                                   else a) for k, v in batch.items()}
    return {k: v.long() if k in ("captions", "lengths") else v
            for k, v in MH.global_batch(mesh, batch).items()}


def distributed_init_from_env(device="cuda") -> bool:
    """Join a world when IC_COORDINATOR / IC_NUM_PROCESSES / IC_PROCESS_ID
    are set; no-op (False) otherwise.  Trainers call this unconditionally
    before they load any data.  ``device`` picks the backend (NCCL for
    CUDA, gloo for the CPU)."""
    coord = os.environ.get("IC_COORDINATOR")
    if not coord:
        return False
    on = MH.initialize(coord, num_processes=int(os.environ["IC_NUM_PROCESSES"]),
                       process_id=int(os.environ["IC_PROCESS_ID"]),
                       device=device)
    if on:
        info = MH.process_info()
        print(f"[multihost] process {info['process_index']}/"
              f"{info['process_count']} joined {coord}")
    return on


def maybe_mesh(batch_size: int, enabled: bool = True, device="cuda"):
    """This process's ``Mesh`` in a world of more than one process; None
    otherwise (one process runs on its one device).

    ``batch_size`` is the loader's batch: the per-process batch when each
    process loads its own rows, the global batch when the world's loader
    batches are global.  A multi-process run refuses ``enabled=False``
    (independent per-process training silently diverges: every process
    would write the same checkpoint files) and a global batch that does not
    divide over its processes."""
    rank, n = MS.world()
    if n > 1 and not enabled:
        raise ValueError(
            "multi-host run requires data parallelism: data_parallel=False "
            f"with {n} processes would train process-independent models")
    if not enabled or n == 1:
        return None
    global_batch = batch_size if MH.split_batches() else batch_size * n
    if global_batch % n:
        raise ValueError(
            f"multi-host run: global batch {global_batch} must divide the "
            f"{n} global devices")
    return MS.create_mesh(device)


def cards_to_spawn(batch_size: int, enabled: bool, device) -> int:
    """How many processes, one per card, a trainer should start for data
    parallelism: the cards visible when it runs on ``cuda`` without an
    index, with no world and no ``IC_COORDINATOR``, and more than one card;
    else 0.  A batch that does not divide over the cards runs on one card,
    as the JAX function runs replicated."""
    dev = torch.device(device)
    if (not enabled or dev.type != "cuda" or dev.index is not None
            or MS.data_size() > 1 or os.environ.get("IC_COORDINATOR")):
        return 0
    n = torch.cuda.device_count()
    if n <= 1:
        return 0
    if batch_size % n:
        print(f"[dp] global batch {batch_size} not divisible by {n} "
              "devices: running on one card")
        return 0
    return n


def run_per_card(fn, n: int, kwargs: Dict):
    """``fn(**kwargs)`` as n processes, one per card, this one rank 0
    (``parallel.multihost.launch`` with global loader batches); returns
    rank 0's result."""
    print(f"[dp] training over {n} cards, one process each")
    return MH.launch(fn, [f"cuda:{i}" for i in range(n)], kwargs=kwargs,
                     split=True)


def rank_seed(seed: int, mesh) -> int:
    """The seed of a rank's dropout and augmentation draws: ``seed`` at
    data index 0 (and in one process), a distinct one at each other data
    index.  The model ranks of one data index draw alike, so that their
    student replicas stay identical, as JAX's replicated student is one."""
    return seed if mesh is None else seed + 1_000_003 * mesh.data_index


def is_primary(mesh) -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return mesh is None or mesh.rank == 0


def step_context(mesh):
    """A no-op: the JAX function enters a policy that runs the Pallas
    kernels per batch shard under GSPMD.  Here each rank already calls the
    kernels on its own rows."""
    return contextlib.nullcontext()


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
