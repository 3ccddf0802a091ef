"""Processes of a data-parallel world
(``imagecaptioner_tpu/parallel/multihost.py``).

The JAX module joins several hosts into one ``jax.distributed`` runtime,
each host driving its local devices.  The port runs one process per card
in a ``torch.distributed`` world:

  * ``initialize`` joins the world (``init_process_group``): a no-op
    (False) with no arguments, with ``num_processes <= 1`` or when a world
    already exists, so that trainers call it unconditionally;
  * ``process_info`` and ``host_shard`` (each data index's rows of a
    dataset: strided, deterministic, equal-size, the JAX function's
    indices);
  * ``global_batch``: this process's part of the global batch on its card
    (each process holds only its own rows);
  * ``launch``: one process per device, started with ``spawn`` (CUDA
    forbids ``fork``), joined over a file store.  The trainers use it when
    several cards are visible and no world exists, which is what the JAX
    trainers' default (one process over every device) does.

The backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one.  NCCL refuses two ranks on one card ("Duplicate GPU detected");
gloo takes CUDA tensors, so two processes sharing one card run over gloo.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_SPLIT = False   # the world's loader batches are global (see core/mesh.Mesh)


def split_batches() -> bool:
    return _SPLIT


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
    split: bool = False,
) -> bool:
    """Join the ``torch.distributed`` world; True if distributed mode is on.

    ``coordinator_address`` is ``host:port`` (TCP) or an ``init_method``
    URL (``tcp://...``, ``file://...``).  ``device`` is this process's
    device (default ``cuda``); it picks the backend (NCCL for CUDA, gloo
    for the CPU) unless ``backend`` is given, and a CUDA device becomes the
    process's current card.  ``split``: the loaders' batches are global
    (``core/mesh.Mesh``)."""
    global _SPLIT
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return False
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    _SPLIT = split
    return True


def shutdown() -> None:
    """Leave the world (no-op without one)."""
    global _SPLIT
    from imagecaptioner_tpu_torch.core import mesh as MS

    if dist.is_initialized():
        dist.destroy_process_group()
    _SPLIT = False
    MS._MESH = None


def process_info() -> Dict[str, int]:
    if dist.is_initialized():
        return {"process_index": dist.get_rank(),
                "process_count": dist.get_world_size()}
    return {"process_index": 0, "process_count": 1}


def host_shard(
    n_examples: int,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """This process's dataset indices: strided, deterministic, equal-size.

    Every process gets exactly ``n_examples // process_count`` indices
    (equal sizes keep the per-process batch shapes static; the remainder
    rows are dropped, as the loader's drop_last drops them).  The defaults
    are this rank's data index and the data axis's size (``core/mesh``):
    the model ranks of one data index load the same rows."""
    from imagecaptioner_tpu_torch.core import mesh as MS

    pi = MS.data_index() if process_index is None else process_index
    pc = MS.data_size() if process_count is None else process_count
    per = n_examples // pc
    return np.arange(n_examples)[pi::pc][:per]


def global_batch(mesh, local: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """This process's part of the global batch, as tensors on its card.

    Each process loaded only its own rows (``host_shard``): ``images``
    (B_local, ...) and ``lengths`` (B_local,) are its block of the global
    batch's axis 0, time-major ``captions`` (T, B_local) of axis 1, which
    is what the JAX function's global array holds on this process's
    devices."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in local.items()}


def _rank_main(rank: int, devices: Sequence[str], init_file: str,
               backend: Optional[str], split: bool, timeout_s: float,
               fn: Callable, args: tuple, kwargs: dict):
    initialize(f"file://{init_file}", len(devices), rank,
               device=devices[rank], backend=backend, timeout_s=timeout_s,
               split=split)
    try:
        return fn(*args, **dict(kwargs, device=devices[rank]))
    finally:
        shutdown()


def launch(fn: Callable, devices: Sequence[str], *, args: tuple = (),
           kwargs: Optional[dict] = None, backend: Optional[str] = None,
           split: bool = False, in_parent: bool = True,
           timeout_s: float = 600.0, join_timeout_s: Optional[float] = None,
           init_file: Optional[str] = None):
    """Run ``fn(*args, **kwargs, device=devices[r])`` as rank r of a world
    of ``len(devices)`` processes joined over a file store.

    With ``in_parent`` this process is rank 0 and ``fn``'s result is
    returned; the others are spawned.  Otherwise every rank is spawned and
    the result is None.  ``fn`` and its arguments must pickle.  Every rank
    joins with ``timeout_s`` for its collectives, and the spawned ones are
    waited for ``join_timeout_s`` (default ``timeout_s``) seconds past rank
    0, or past their start: one still running then is killed, and a rank
    that fails or is killed raises here."""
    kwargs = dict(kwargs or {})
    devices = [str(d) for d in devices]
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="ic_world_")
        init_file = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    first = 1 if in_parent else 0
    procs = [ctx.Process(target=_rank_main,
                         args=(r, devices, init_file, backend, split,
                               timeout_s, fn, args, kwargs))
             for r in range(first, len(devices))]
    for p in procs:
        p.start()
    result = None
    try:
        if in_parent:
            result = _rank_main(0, devices, init_file, backend, split,
                                timeout_s, fn, args, kwargs)
    finally:
        deadline = time.monotonic() + (timeout_s if join_timeout_s is None
                                       else join_timeout_s)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    bad = {r: p.exitcode for r, p in zip(range(first, len(devices)), procs)
           if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks {sorted(bad)} of the world failed (exit "
                           f"codes {bad})")
    return result
