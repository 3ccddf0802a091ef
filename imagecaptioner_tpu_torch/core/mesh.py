"""A data-parallel world over ``torch.distributed``
(``imagecaptioner_tpu/core/mesh.py``).

JAX runs one process over a device mesh and lets GSPMD split a global batch
over its ``data`` axis.  The port runs one process per card: a ``Mesh`` is
this process's place in the ``torch.distributed`` world (rank, world size,
its card), and the collectives are explicit.  The semantics kept are the
JAX ones: a step on W ranks of B rows computes what one process computes
on the W·B rows of the global batch.  What ``P("data")`` gives each device,
a contiguous block of the global batch, is what ``shard_batch`` (batch
axis 0) and ``shard_time_major`` (axis 1, the captions' batch axis) take.

The global reductions the train steps need (``psum_over_data``,
``pmax_over_data``, ``data_size``) are here too: the losses' normalizers,
the batch norms' statistics and the gradients go through them, and with no
world (one process) each is the identity.

Only the ``data`` axis is ported: a ``model`` axis larger than 1 is tensor
or sequence parallelism, which waits for its own slice (ROADMAP Queue 1,
TP/SP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world.  ``split``: the
    loaders' batches are the global batch and each rank takes its block
    (one process per card started by ``parallel.multihost.launch``);
    otherwise each process loads its own rows (``host_shard``) and its
    batch is its block already."""
    rank: int
    size: int
    device: torch.device
    split: bool = False


def world() -> Tuple[int, int]:
    """(rank, size) of the ``torch.distributed`` world; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_size() -> int:
    """Ranks on the data axis: the world's size, 1 without a world."""
    return world()[1]


def create_mesh(device=None, shape: Optional[Tuple[int, int]] = None,
                *, split: Optional[bool] = None) -> Mesh:
    """This process's ``Mesh``.  ``shape`` is (data, model) and defaults
    to (world size, 1).  ``device`` defaults to ``cuda``; a ``cuda``
    without an index is the card ``rank % cards visible``, and the card
    becomes the process's current one."""
    from imagecaptioner_tpu_torch.parallel import multihost as MH

    rank, size = world()
    if shape is None:
        shape = (size, 1)
    if shape[1] != 1:
        raise NotImplementedError(
            f"a '{MODEL_AXIS}' axis of {shape[1]} is tensor or sequence "
            "parallelism, not ported yet (ROADMAP Queue 1, TP/SP); the "
            "port's mesh has a data axis only")
    if shape[0] != size:
        raise ValueError(f"mesh shape {tuple(shape)} != {size} processes")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)       # NCCL's communicator takes it
    return Mesh(rank, size, dev,
                MH.split_batches() if split is None else split)


def batch_block(x, mesh: Mesh, axis: int):
    """This rank's contiguous block of ``x``'s batch ``axis``."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch {n} not divisible by the mesh's data axis "
                         f"({mesh.size})")
    b = n // mesh.size
    idx = [slice(None)] * axis + [slice(mesh.rank * b, (mesh.rank + 1) * b)]
    return x[tuple(idx)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's contiguous block of every leaf's axis 0 (images
    (B, ...), lengths (B,)); time-major captions go through
    ``shard_time_major``."""
    return _tree_map(lambda x: batch_block(x, mesh, 0), batch)


def shard_time_major(mesh: Mesh, x: Any) -> Any:
    """This rank's block of a time-major (T, B, ...) array's axis 1."""
    return _tree_map(lambda a: batch_block(a, mesh, 1), x)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast rank 0's values into every rank's tensors in place (a
    module's parameters and buffers, or a tree of tensors); returns
    ``tree``."""
    if mesh is None or mesh.size == 1:
        return tree
    tensors = []

    def take(x):
        if isinstance(x, torch.nn.Module):
            tensors.extend(list(x.parameters()) + list(x.buffers()))
        elif isinstance(x, torch.Tensor):
            tensors.append(x)
    _tree_map(take, tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree


def local_device_count() -> int:
    return torch.cuda.device_count()


def psum_over_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor, outside autograd);
    ``x`` itself with no world."""
    if data_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def pmax_over_data(x: torch.Tensor) -> torch.Tensor:
    """The maximum of ``x`` over the ranks, as ``psum_over_data``."""
    if data_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def psum_tensors_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place: one all-reduce per
    (dtype, device) group of a flat copy (a no-op with no world)."""
    if data_size() == 1:
        return
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])
