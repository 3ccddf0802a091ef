"""CaptioningTeacher (``imagecaptioner_tpu/models/teacher.py``): ViT-S/16
encoder, features projected to the embed size, caption embeddings +
sinusoidal PE, causal post-LN transformer decoder, pre-output LayerNorm and
the output head.  images (B, 3, S, S) + captions (T, B) time-major ->
logits (T, B, V).

The KD step runs it frozen in eval mode; ``ops/decode.py`` decodes from it
(greedy and beam search over ``encode_image``'s memory);
``train/train_teacher.py`` trains it, with ``set_trainable`` marking what
``teacher_trainable_mask`` unfreezes.

The KD step's frozen teacher may be placed for tensor parallelism
(``parallel/tp.py``) and run under the sequence policy
(``parallel/sp.py``): the memory and the caption stream are cut into the
model ranks' token blocks where JAX's ``teacher_apply`` constrains them
(``models/teacher.py:94-101``), and the memory and the logits come back
whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.core.modules import (Embedding, LayerNorm,
                                                   Linear, dropout,
                                                   embedding_init,
                                                   layer_norm_init,
                                                   cast_parameters,
                                                   linear_init,
                                                   sinusoidal_positional_encoding,
                                                   xavier_uniform)
from imagecaptioner_tpu_torch.models.transformer import (DecoderLayer,
                                                         decoder_apply)
from imagecaptioner_tpu_torch.models.vit import ViT, vit_trainable_mask
from imagecaptioner_tpu_torch.parallel import sp, tp
from imagecaptioner_tpu_torch.utils.checkpoint import load_checkpoint
from imagecaptioner_tpu_torch.utils.convert import jax_teacher_to_state_dict


class Teacher(nn.Module):
    def __init__(self, cfg: TeacherConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_size
        self.encoder = ViT(cfg)
        self.embedding = Embedding(cfg.vocab_size, e)
        self.decoder = nn.ModuleList(
            DecoderLayer(e, cfg.num_heads, 2 * e, cfg.dropout)
            for _ in range(cfg.num_decoder_layers))
        self.pre_output_norm = LayerNorm(e)
        self.fc_out = Linear(e, cfg.vocab_size)
        self.encoder_projection = (Linear(cfg.encoder_dim, e)
                                   if cfg.encoder_dim != e else None)
        # a constant table, not a parameter: not part of the state_dict
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_positional_encoding(cfg.max_pe_len, e)),
            persistent=False)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """ViT features + projection -> memory (B, tokens, embed_size)."""
        feats = self.encoder(images)
        if self.encoder_projection is not None:
            feats = self.encoder_projection(feats)
        return feats

    def embed_captions(self, captions_tb: torch.Tensor, *,
                       generator: Optional[torch.Generator] = None,
                       position_offset: int = 0) -> torch.Tensor:
        """(T, B) -> (B, T, E) with sinusoidal PE + dropout."""
        T = captions_tb.shape[0]
        emb = self.embedding(captions_tb.t())
        pe = self.pe[position_offset:position_offset + T]
        emb = emb + pe[None].to(emb.dtype)
        return dropout(emb, self.cfg.dropout, self.training, generator)

    def forward(self, images: Optional[torch.Tensor], captions: torch.Tensor,
                *, memory: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``teacher_apply`` -> logits (T, B, V).  Pass ``memory`` to reuse
        a precomputed encoding.  The caption stream keeps the embedding's
        dtype and the memory the images', as in JAX: a float32 stream
        against a bf16 memory computes in float32 wherever the two meet,
        except cross-attention's K/V, its P·V and its out-projection, which
        follow the memory.  A teacher cast to bf16 (the KD step's,
        ``distill.wrapper.cast_teacher``) runs its stream in bf16."""
        if memory is None:
            memory = self.encode_image(images)
        x = self.embed_captions(captions, generator=generator)
        seq = None
        if sp.active():
            sp.check_frozen(self)
            seq = (x.shape[1], memory.shape[1])
            memory, x = sp.shard_seq(memory, 1), sp.shard_seq(x, 1)
        x = decoder_apply(self.decoder, x, memory, causal=True,
                          generator=generator, seq=seq)
        x = dropout(self.pre_output_norm(x), self.cfg.dropout, self.training,
                    generator)
        if seq is None:
            return self.fc_out(x).transpose(0, 1)
        if tp.is_placed(self.fc_out):
            # the vocabulary's blocks gather over ranks of the same rows
            return self.fc_out(sp.gather_seq(x, 1, seq[0])).transpose(0, 1)
        return sp.gather_seq(self.fc_out(x), 1, seq[0]).transpose(0, 1)


def teacher_trainable_mask(model: Teacher, cfg: TeacherConfig
                           ) -> Dict[str, bool]:
    """Parameter name -> trainable, as ``teacher.teacher_trainable_mask``:
    the ViT partly frozen (``vit_trainable_mask``), everything else
    trains."""
    vit = vit_trainable_mask(model.encoder, cfg)
    return {name: vit[name[len("encoder."):]] if name.startswith("encoder.")
            else True for name, _ in model.named_parameters()}


def set_trainable(model: Teacher, cfg: TeacherConfig) -> Dict[str, bool]:
    """Apply ``teacher_trainable_mask`` as ``requires_grad``."""
    mask = teacher_trainable_mask(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


def count_parameters(model: nn.Module) -> int:
    """Parameter elements, frozen ones included (``tree_size``)."""
    return sum(p.numel() for p in model.parameters())


def teacher_init(seed: int, cfg: TeacherConfig) -> dict:
    """Random parameter tree in the layout of the JAX ``teacher_init``,
    drawn from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    e = cfg.embed_size
    p = {
        "encoder": ViT.init(rng, cfg),
        "embedding": embedding_init(rng, cfg.vocab_size, e),
        "decoder": [DecoderLayer.init(rng, e, 2 * e)
                    for _ in range(cfg.num_decoder_layers)],
        "pre_output_norm": layer_norm_init(e),
        "fc_out": {"weight": xavier_uniform(rng, (cfg.vocab_size, e)),
                   "bias": np.zeros(cfg.vocab_size, np.float32)},
    }
    if cfg.encoder_dim != e:
        p["encoder_projection"] = linear_init(rng, cfg.encoder_dim, e)
    return p


def load_teacher(path: str, device, dtype: torch.dtype = torch.float32):
    """A teacher checkpoint written by the teacher trainer -> ``(Teacher in
    eval mode on device, cfg)``.  Its ``vocab_size`` and ``model_config``
    rebuild the architecture; parameters in ``dtype``."""
    ckpt = load_checkpoint(path)
    cfg = TeacherConfig(vocab_size=int(ckpt["vocab_size"]),
                        **dict(ckpt.get("model_config", {})))
    teacher = Teacher(cfg)
    teacher.load_state_dict(
        jax_teacher_to_state_dict(ckpt["model_state_dict"]["params"]),
        strict=True)
    cast_parameters(teacher, dtype)
    return teacher.to(device).eval(), cfg
