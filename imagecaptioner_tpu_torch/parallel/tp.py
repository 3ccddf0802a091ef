"""Tensor parallelism of the frozen teacher over the mesh's ``model`` axis
(``imagecaptioner_tpu/parallel/tp.py``).

JAX places the teacher's parameters with Megatron-style shardings
(``teacher_tp_shardings``) and lets GSPMD insert the collectives.  Here
``place_teacher_tp`` swaps the teacher's modules, in place, for shards that
hold only this rank's slice, and the collectives are explicit over the
model group:

  * ViT ``qkv`` and ``fc1``, the decoder's packed ``in_proj`` and
    ``linear1``: column-parallel (a plain ``Linear`` of the rank's output
    rows);
  * ViT ``proj`` and ``fc2``, the decoder's ``out_proj`` and ``linear2``:
    row-parallel (``RowParallelLinear``: the rank's input columns, the
    partial products summed over the model group in float32, the bias
    added once after the sum, as JAX's replicated bias is);
  * ``embedding`` and ``fc_out``: vocabulary-parallel (the rank's rows of
    the vocabulary; ids outside them embed to zeros before an all-reduce;
    the logits are gathered to the whole vocabulary);
  * everything else replicated: the norms, ``patch_embed``, ``cls_token``,
    ``pos_embed``, ``encoder_projection``.

Two things differ from a layout.  A packed projection is split by head,
not into contiguous blocks: JAX's ``P(MODEL_AXIS, None)`` on the (3D, D)
``qkv`` gives rank 0 all of q and part of k, which GSPMD's collectives make
right; with explicit collectives each rank owns whole heads, the q, k and v
rows of its heads (``packed_rows``).  And splits are ``np.array_split``
blocks, uneven where the count does not divide (3 ViT heads over 2 ranks:
2 + 1; V = 2994 over 4 ranks: 749 + 749 + 748 + 748), as GSPMD's are.

The attention modules keep ``num_heads`` local; everything else of the
forwards is unchanged (``core/modules.multi_head_attention``,
``models/vit.Block``).  The placed teacher is the KD step's frozen teacher:
a forward in train mode or with gradients on raises (``sp.check_frozen``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core.modules import Embedding, Linear
from imagecaptioner_tpu_torch.parallel import sp


def _block(n: int, mesh: MS.Mesh) -> slice:
    """This rank's ``np.array_split`` block of n."""
    sizes = MS.split_sizes(n, mesh.model_size)
    first = sum(sizes[:mesh.model_index])
    return slice(first, first + sizes[mesh.model_index])


def packed_rows(dim: int, heads: int, mesh: MS.Mesh) -> np.ndarray:
    """The rows of a packed (3·dim, dim) q/k/v projection that this rank
    owns: the q, k and v rows of its block of whole heads."""
    hd = dim // heads
    own = _block(heads, mesh)
    rows = np.arange(own.start * hd, own.stop * hd)
    return np.concatenate([rows, dim + rows, 2 * dim + rows])


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().clone().contiguous(), requires_grad=False)


def _column(lin: Linear, rows) -> Linear:
    """A column-parallel shard: the output ``rows`` of ``lin``."""
    rows = torch.as_tensor(rows, device=lin.weight.device)
    out = Linear(lin.weight.shape[1], len(rows))
    out.weight = _param(lin.weight[rows])
    out.bias = _param(lin.bias[rows])
    return out


def _partial(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ Wᵀ`` as float32, the product ``modules.dense`` rounds once:
    bf16 operands on tensor cores with a float32 result on the card,
    float32 operands elsewhere."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), weight.to(x.dtype).t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], weight.shape[0])
    return nn.functional.linear(x.float(), weight.to(x.dtype).float())


class RowParallelLinear(nn.Module):
    """A row-parallel shard: this rank's input columns of the weight, the
    whole bias.  The partial products are summed over the model group in
    float32 (all-reduced; under the sequence policy reduce-scattered back
    to the rank's block of the token axis 1), the bias is added once after
    the sum, and the result is rounded to ``x.dtype`` once, as
    ``modules.dense`` rounds."""
    model_parallel = True

    def __init__(self, lin: Linear, cols: slice, mesh: MS.Mesh):
        super().__init__()
        self.weight = _param(lin.weight[:, cols])
        self.bias = _param(lin.bias)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp.check_frozen(self)
        y = _partial(x, self.weight)
        y = (sp.reduce_scatter_seq(y, 1) if sp.active()
             else MS.all_reduce_model(y, self.mesh))
        return (y + self.bias.float()).to(x.dtype)


class VocabParallelEmbedding(nn.Module):
    """This rank's rows ``[first, first + rows)`` of the embedding table:
    ids outside them embed to zeros, and the all-reduce over the model
    group gives every rank the whole lookup (exactly: one term is not
    zero)."""
    model_parallel = True

    def __init__(self, emb: Embedding, rows: slice, mesh: MS.Mesh):
        super().__init__()
        self.weight = _param(emb.weight[rows])
        self.first, self.mesh = rows.start, mesh

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        sp.check_frozen(self)
        local = ids - self.first
        inside = (local >= 0) & (local < self.weight.shape[0])
        out = nn.functional.embedding(
            local.clamp(0, self.weight.shape[0] - 1), self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return MS.all_reduce_model(out.contiguous(), self.mesh)


class VocabParallelLinear(nn.Module):
    """The output head's rows of this rank's block of the vocabulary; the
    logits are gathered over the model group to the whole vocabulary."""
    model_parallel = True

    def __init__(self, lin: Linear, rows: slice, mesh: MS.Mesh, vocab: int):
        super().__init__()
        self.weight = _param(lin.weight[rows])
        self.bias = _param(lin.bias[rows])
        self.sizes = MS.split_sizes(vocab, mesh.model_size)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from imagecaptioner_tpu_torch.core.modules import dense

        sp.check_frozen(self)
        return MS.gather_model(dense(x, self.weight, self.bias), -1,
                               self.sizes, self.mesh)


def is_placed(module: nn.Module) -> bool:
    """Whether ``module`` is a shard whose result spans the model group (a
    row- or vocabulary-parallel one): its block ran Megatron's way."""
    return getattr(module, "model_parallel", False)


def _head_cols(dim: int, heads: int, mesh: MS.Mesh) -> slice:
    """The columns of an out-projection that this rank's heads feed."""
    own, hd = _block(heads, mesh), dim // heads
    return slice(own.start * hd, own.stop * hd)


def _place_mha(mha, heads: int, mesh: MS.Mesh) -> None:
    dim = mha.in_proj_weight.shape[1]
    rows = torch.as_tensor(packed_rows(dim, heads, mesh),
                           device=mha.in_proj_weight.device)
    mha.in_proj_weight = _param(mha.in_proj_weight[rows])
    mha.in_proj_bias = _param(mha.in_proj_bias[rows])
    mha.out_proj = RowParallelLinear(mha.out_proj,
                                     _head_cols(dim, heads, mesh), mesh)
    mha.num_heads = MS.split_sizes(heads, mesh.model_size)[mesh.model_index]


def teacher_tp_shardings(teacher) -> dict:
    """How each leaf of the teacher splits over the model axis (JAX's
    ``teacher_tp_shardings``): parameter name -> "out" (output rows;
    by head for the packed projections), "in" (input columns),
    "vocab" (vocabulary rows) or "replicated"."""
    out = {}
    for name, _ in teacher.named_parameters():
        leaf = name.rsplit(".", 1)
        how = "replicated"
        if name.startswith("encoder.blocks."):
            if ".qkv." in name or ".fc1." in name:
                how = "out"
            elif ".proj." in name or ".fc2." in name:
                how = "in" if leaf[1] == "weight" else "replicated"
        elif name.startswith("decoder."):
            if ".in_proj_" in name or ".linear1." in name:
                how = "out"
            elif ".out_proj." in name or ".linear2." in name:
                how = "in" if leaf[1] == "weight" else "replicated"
        elif name.startswith(("embedding.", "fc_out.")):
            how = "vocab"
        out[name] = how
    return out


def place_teacher_tp(mesh: MS.Mesh, teacher, cfg):
    """Swap ``teacher``'s modules in place for this rank's shards (module
    docstring) and return it.  A model axis of 1 leaves it whole."""
    m = mesh.model_size
    if m == 1:
        return teacher
    for what, heads in (("encoder_heads", cfg.encoder_heads),
                        ("num_heads", cfg.num_heads)):
        if heads < m:
            raise ValueError(f"{what}={heads} over a model axis of {m} "
                             "leaves a rank without a head")
    for blk in teacher.encoder.blocks:
        dim = blk.attn["proj"].weight.shape[0]
        blk.attn["qkv"] = _column(
            blk.attn["qkv"], packed_rows(dim, cfg.encoder_heads, mesh))
        blk.attn["proj"] = RowParallelLinear(
            blk.attn["proj"], _head_cols(dim, cfg.encoder_heads, mesh), mesh)
        blk.num_heads = MS.split_sizes(
            cfg.encoder_heads, mesh.model_size)[mesh.model_index]
        hidden = _block(blk.mlp["fc1"].weight.shape[0], mesh)
        blk.mlp["fc1"] = _column(blk.mlp["fc1"],
                                 np.arange(hidden.start, hidden.stop))
        blk.mlp["fc2"] = RowParallelLinear(blk.mlp["fc2"], hidden, mesh)
    for layer in teacher.decoder:
        _place_mha(layer.self_attn, cfg.num_heads, mesh)
        _place_mha(layer.multihead_attn, cfg.num_heads, mesh)
        ff = _block(layer.linear1.weight.shape[0], mesh)
        layer.linear1 = _column(layer.linear1, np.arange(ff.start, ff.stop))
        layer.linear2 = RowParallelLinear(layer.linear2, ff, mesh)
    vocab = teacher.embedding.weight.shape[0]
    rows = _block(vocab, mesh)
    teacher.embedding = VocabParallelEmbedding(teacher.embedding, rows, mesh)
    teacher.fc_out = VocabParallelLinear(teacher.fc_out, rows, mesh, vocab)
    return teacher.train(teacher.training)    # the shards in its mode
