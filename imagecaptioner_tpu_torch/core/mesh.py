"""A (data, model) world over ``torch.distributed``
(``imagecaptioner_tpu/core/mesh.py``).

JAX runs one process over a device mesh and lets GSPMD split a global batch
over its ``data`` axis and the teacher's weights and token axes over its
``model`` axis.  The port runs one process per card: a ``Mesh`` is this
process's place in the ``torch.distributed`` world, and the collectives are
explicit.  Rank r sits at data index ``r // m`` and model index ``r % m``
of a (d, m) mesh, as JAX's ``np.asarray(devices).reshape(shape)`` lays the
devices out.  The semantics kept are the JAX ones: a step on d data blocks
of B rows computes what one process computes on the d·B rows of the global
batch.  What ``P("data")`` gives each device, a contiguous block of the
global batch, is what ``shard_batch`` (batch axis 0) and
``shard_time_major`` (axis 1, the captions' batch axis) take: the block of
the rank's data index, the same for every model rank of it.

The global reductions the train steps need (``psum_over_data``,
``pmax_over_data``, ``data_size``) run over the data axis alone: the
losses' normalizers, the batch norms' statistics and the gradients go
through them, and with no world (one process) each is the identity.  The
model axis carries the frozen teacher's tensor and sequence parallelism
(``parallel/tp.py``, ``parallel/sp.py``) over ``Mesh.model_group``.
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
    """This process's place in the (data, model) world.  ``split``: the
    loaders' batches are the global batch and each rank takes its block
    (one process per card started by ``parallel.multihost.launch``);
    otherwise each process loads its own rows (``host_shard``) and its
    batch is its block already.  ``data_group`` joins the ranks of one
    model index (None: the whole world), ``model_group`` those of one data
    index (None: a model axis of 1).  A copy of a module that holds the
    mesh (``copy.deepcopy``) shares it: the mesh names the world."""
    rank: int
    size: int
    device: torch.device
    split: bool = False
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    def __deepcopy__(self, memo):
        return self


_MESH: Optional[Mesh] = None      # the last mesh ``create_mesh`` made


def world() -> Tuple[int, int]:
    """(rank, size) of the ``torch.distributed`` world; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def current_mesh() -> Optional[Mesh]:
    """The mesh ``create_mesh`` made in this world, None without one."""
    if _MESH is None or world() != (_MESH.rank, _MESH.size):
        return None
    return _MESH


def data_size() -> int:
    """Ranks on the data axis: the world's size over the current mesh's
    model axis, 1 without a world."""
    mesh = current_mesh()
    return world()[1] if mesh is None else mesh.data_size


def data_index() -> int:
    """This rank's data index (its rank with a model axis of 1)."""
    mesh = current_mesh()
    return world()[0] if mesh is None else mesh.data_index


def _data_group():
    """The group of the data-axis reductions: None (the world) unless the
    current mesh has a model axis."""
    mesh = current_mesh()
    return None if mesh is None else mesh.data_group


def _groups(d: int, m: int, rank: int):
    """The data and model groups of a (d, m) mesh that hold ``rank``.  Every
    rank makes every group, in one order: ``new_group`` is collective."""
    data_group = model_group = None
    for j in range(m):                       # one data group a model index
        g = dist.new_group([i * m + j for i in range(d)])
        if rank % m == j:
            data_group = g
    for i in range(d):                       # one model group a data index
        g = dist.new_group([i * m + j for j in range(m)])
        if rank // m == i:
            model_group = g
    return data_group, model_group


def create_mesh(device=None, shape: Optional[Tuple[int, int]] = None,
                *, split: Optional[bool] = None) -> Mesh:
    """This process's ``Mesh``, which the data-axis reductions then use.
    ``shape`` is (data, model) and defaults to (world size, 1); data x model
    must be the world's size.  ``device`` defaults to ``cuda``; a ``cuda``
    without an index is the card ``rank % cards visible``, and the card
    becomes the process's current one."""
    global _MESH
    from imagecaptioner_tpu_torch.parallel import multihost as MH

    rank, size = world()
    if shape is None:
        shape = (size, 1)
    d, m = (int(n) for n in shape)
    if d < 1 or m < 1 or d * m != size:
        raise ValueError(f"mesh shape {tuple(shape)} != {size} processes")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)       # NCCL's communicator takes it
    groups = _groups(d, m, rank) if m > 1 else (None, None)
    _MESH = Mesh(rank, size, dev,
                 MH.split_batches() if split is None else split, m, *groups)
    return _MESH


def batch_block(x, mesh: Mesh, axis: int):
    """The contiguous block of ``x``'s batch ``axis`` at this rank's data
    index."""
    n, i = x.shape[axis], mesh.data_index
    if n % mesh.data_size:
        raise ValueError(f"batch {n} not divisible by the mesh's data axis "
                         f"({mesh.data_size})")
    b = n // mesh.data_size
    idx = [slice(None)] * axis + [slice(i * b, (i + 1) * b)]
    return x[tuple(idx)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's data block of every leaf's axis 0 (images
    (B, ...), lengths (B,)); time-major captions go through
    ``shard_time_major``."""
    return _tree_map(lambda x: batch_block(x, mesh, 0), batch)


def shard_time_major(mesh: Mesh, x: Any) -> Any:
    """This rank's data block of a time-major (T, B, ...) array's axis
    1."""
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
    """The sum of ``x`` over the data axis (a new tensor, outside
    autograd); ``x`` itself with one data index."""
    if data_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_data_group())
    return out


def pmax_over_data(x: torch.Tensor) -> torch.Tensor:
    """The maximum of ``x`` over the data axis, as ``psum_over_data``."""
    if data_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_data_group())
    return out


def psum_tensors_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the data axis in place: one all-reduce per
    (dtype, device) group of a flat copy (a no-op with one data index)."""
    if data_size() == 1:
        return
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_data_group())
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def agree_over_model_(tensors: List[torch.Tensor]) -> None:
    """Give every model rank of a data index model index 0's values of
    ``tensors``, in place: one broadcast per (dtype, device) group of a
    flat copy over the model group (a no-op without a model axis).  The
    replicas of one data index compute the same gradients, but the card's
    atomic backward algorithms leave them different in their last bits;
    JAX's replicated student is one value, so the port's replicas must
    agree bit for bit."""
    mesh = current_mesh()
    if mesh is None or mesh.model_size == 1:
        return
    src = mesh.data_index * mesh.model_size          # its global rank
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=mesh.model_group)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


# ---------------------------------------------------------------------------
# Model-axis collectives (``parallel/tp.py``, ``parallel/sp.py``).  Blocks
# may be uneven, as GSPMD's are; gloo takes only equal blocks in a gather,
# so every block is padded to the largest and trimmed after.
# ---------------------------------------------------------------------------


# the newer names where this torch has them (the older ones are deprecated)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def split_sizes(n: int, parts: int) -> List[int]:
    """``np.array_split``'s block sizes of n over ``parts``."""
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


def all_reduce_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the model group, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return x


def gather_model(x: torch.Tensor, axis: int, sizes: List[int],
                 mesh: Mesh) -> torch.Tensor:
    """The whole ``axis`` from every model rank's block of it: rank j holds
    ``sizes[j]`` entries (this rank's ``x``), and the result is the blocks
    in rank order, contiguous (the attention kernel's operands must be)."""
    m, big = mesh.model_size, max(sizes)
    x = x.movedim(axis, 0)
    if x.shape[0] < big:
        x = torch.cat([x, x.new_zeros((big - x.shape[0],) + x.shape[1:])])
    x = x.contiguous()
    out = x.new_empty((m * big,) + x.shape[1:])
    _ALL_GATHER(out, x, group=mesh.model_group)
    if all(s == big for s in sizes):
        whole = out
    else:
        whole = torch.cat([out[j * big:j * big + s]
                           for j, s in enumerate(sizes)])
    return whole.movedim(0, axis).contiguous()


def reduce_scatter_model(x: torch.Tensor, axis: int, sizes: List[int],
                         mesh: Mesh) -> torch.Tensor:
    """This rank's block (``sizes[model_index]`` entries of ``axis``) of
    the sum of ``x`` over the model group, where ``x`` holds the whole
    axis."""
    m, big = mesh.model_size, max(sizes)
    x = x.movedim(axis, 0)
    blocks = x.new_zeros((m, big) + x.shape[1:])
    for j, part in enumerate(x.split(sizes)):
        blocks[j, :part.shape[0]] = part
    out = x.new_empty((big,) + x.shape[1:])
    _REDUCE_SCATTER(out, blocks.reshape((m * big,) + x.shape[1:]),
                    op=dist.ReduceOp.SUM, group=mesh.model_group)
    return out[:sizes[mesh.model_index]].movedim(0, axis)
