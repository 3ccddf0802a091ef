"""Sequence parallelism of the frozen teacher over the mesh's ``model`` axis
(``imagecaptioner_tpu/parallel/sp.py``).

The teacher's two long token axes, the ViT's patch tokens and the
teacher-forced caption time axis, carry its transformer FLOPs.  Under a
``sequence_sharding`` policy each model rank keeps one contiguous block of
each token axis, and the forwards gather what global attention needs.
JAX annotates the axes and lets GSPMD insert the collectives; here they are
explicit, at the same four points (``models/vit.py``: the patch tokens
before the blocks and each block's output, which is its rank's block;
``models/teacher.py``: the memory and the caption stream):

  * a token axis of n entries is cut into m blocks of ``ceil(n / m)``, the
    last ones shorter or empty (ViT-S/16's 197 tokens: 99 + 98; the KD
    step's T = 47: 24 + 23).  A rank holds only its real rows; a gather
    pads every block to the largest (gloo takes only equal blocks) and trims
    the padding before anything reads it, so no padded key reaches an
    attention core;
  * under the policy alone (replicated weights) each rank computes K and V
    of its own tokens, gathers them, and attends with its own queries to
    all keys; the caption stream's causal self-attention of the rows
    ``[o, o + Tr)`` runs kernel #2 with ``q_offset = o``;
  * with a teacher placed by ``parallel/tp.py`` the order is Megatron's:
    gather the sequence, the column-parallel product, #2 on the rank's
    heads over the whole sequence, the row-parallel product as a
    reduce-scatter back to token blocks; LayerNorms run on the rank's
    tokens;
  * the memory and the logits come back whole on every rank.

The policy is read at run time by the forwards; the port has no jit cache
to key on it.  Without a policy every function here is the identity, and
with a model axis of 1 too.  The collectives are not differentiable: the
policy serves the KD step's frozen teacher only (eval mode, no gradient;
``check_frozen``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from imagecaptioner_tpu_torch.core import mesh as MS

_POLICY: Optional[Tuple[MS.Mesh, str]] = None


@contextmanager
def sequence_sharding(mesh: MS.Mesh, axis: str = MS.MODEL_AXIS):
    """Shard the teacher's token axes over ``mesh``'s model axis for every
    teacher forward run inside this context."""
    global _POLICY
    if axis != MS.MODEL_AXIS:
        raise ValueError(f"sequence parallelism runs over the "
                         f"'{MS.MODEL_AXIS}' axis, not '{axis}'")
    prev = _POLICY
    _POLICY = (mesh, axis)
    try:
        yield
    finally:
        _POLICY = prev


def active() -> bool:
    return _POLICY is not None


def _mesh() -> Optional[MS.Mesh]:
    """The policy's mesh when its model axis shards anything, else None."""
    if _POLICY is None or _POLICY[0].model_size == 1:
        return None
    return _POLICY[0]


def check_frozen(module: torch.nn.Module) -> None:
    """Raise unless ``module`` runs as the KD step's frozen teacher: eval
    mode, no gradient.  The model-axis collectives have no backward."""
    if module.training or torch.is_grad_enabled():
        raise RuntimeError(
            "a teacher under tensor or sequence parallelism is the KD "
            "step's frozen teacher: run it in eval mode under "
            "torch.no_grad() (no JAX entry point trains it either)")


def block_sizes(n: int, mesh: MS.Mesh) -> list:
    """Each model rank's rows of a token axis of n: blocks of ceil(n/m)."""
    per = -(-n // mesh.model_size)
    return [max(0, min(per, n - j * per)) for j in range(mesh.model_size)]


def local_rows(n: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's block of a token axis of n; (0, n)
    without a policy."""
    mesh = _mesh()
    if mesh is None:
        return 0, n
    per = -(-n // mesh.model_size)
    first = min(mesh.model_index * per, n)
    return first, block_sizes(n, mesh)[mesh.model_index]


def shard_seq(x: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """This rank's block of ``x``'s token axis ``seq_axis`` (a view); ``x``
    itself without a policy."""
    first, rows = local_rows(x.shape[seq_axis])
    if rows == x.shape[seq_axis]:
        return x
    return x.narrow(seq_axis, first, rows)


def gather_seq(x: torch.Tensor, seq_axis: int, n: int) -> torch.Tensor:
    """The whole token axis (n rows) from every rank's block of it; ``x``
    itself without a policy."""
    mesh = _mesh()
    if mesh is None:
        return x
    return MS.gather_model(x, seq_axis, block_sizes(n, mesh), mesh)


def reduce_scatter_seq(x: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """This rank's block of the sum of ``x`` (the whole token axis) over
    the model group: a row-parallel product's output under the policy."""
    mesh = _mesh()
    return MS.reduce_scatter_model(
        x, seq_axis, block_sizes(x.shape[seq_axis], mesh), mesh)
