"""ViT encoder, headless (``imagecaptioner_tpu/models/vit.py``): patch-embed
conv, CLS token + learned position embeddings, ``depth`` pre-norm blocks
(MHSA with qkv bias + 4x exact-GELU MLP), final LayerNorm.  ``forward``
returns all tokens; the teacher taps them as cross-attention memory and as
KD features.  Submodule names follow the JAX tree (timm naming).

The ViT applies no dropout, in training either: the JAX
``vit_forward_features`` defaults ``dropout=0.0`` and the teacher passes
none.  So a training forward is the same forward with gradients through
the blocks; ``vit_trainable_mask`` says which parameters train.  Sequence
parallelism is ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.core.modules import (Conv2d, LayerNorm, Linear,
                                                   _param, conv2d_init, gelu,
                                                   layer_norm_init,
                                                   linear_init)
from imagecaptioner_tpu_torch.ops.attention import attention_core


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = nn.ModuleDict({"qkv": Linear(dim, 3 * dim),
                                   "proj": Linear(dim, dim)})
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": Linear(dim, hidden),
                                  "fc2": Linear(hidden, dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, l, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        a = attention_core(q, k, v, causal=False, scale=1.0 / math.sqrt(hd))
        x = x + self.attn.proj(a.transpose(1, 2).reshape(b, l, d))
        return x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class ViT(nn.Module):
    def __init__(self, cfg: TeacherConfig):
        super().__init__()
        d = cfg.encoder_dim
        self.patch_embed = nn.ModuleDict({"proj": Conv2d(
            3, d, cfg.patch_size, stride=cfg.patch_size, bias=True)})
        self.cls_token = _param(1, 1, d)
        self.pos_embed = _param(1, cfg.num_tokens, d)
        self.blocks = nn.ModuleList(
            Block(d, cfg.encoder_heads, cfg.encoder_mlp_ratio)
            for _ in range(cfg.encoder_depth))
        self.norm = LayerNorm(d)

    @staticmethod
    def init(rng: np.random.Generator, cfg: TeacherConfig) -> dict:
        """Random parameter tree in the layout of ``vit.vit_init``."""
        d = cfg.encoder_dim
        hidden = int(d * cfg.encoder_mlp_ratio)

        def trunc_normal(shape):
            return (0.02 * np.clip(rng.standard_normal(shape), -2.0, 2.0)
                    ).astype(np.float32)

        return {
            "patch_embed": {"proj": conv2d_init(rng, 3, d, cfg.patch_size,
                                                bias=True)},
            "cls_token": trunc_normal((1, 1, d)),
            "pos_embed": trunc_normal((1, cfg.num_tokens, d)),
            "blocks": [{
                "norm1": layer_norm_init(d),
                "attn": {"qkv": linear_init(rng, d, 3 * d),
                         "proj": linear_init(rng, d, d)},
                "norm2": layer_norm_init(d),
                "mlp": {"fc1": linear_init(rng, d, hidden),
                        "fc2": linear_init(rng, hidden, d)},
            } for _ in range(cfg.encoder_depth)],
            "norm": layer_norm_init(d),
        }

    def forward(self, images_nchw: torch.Tensor) -> torch.Tensor:
        """``vit_forward_features``: (B, 3, S, S) -> (B, tokens, dim), final
        norm applied."""
        x = self.patch_embed.proj(images_nchw)           # (B, d, S/p, S/p)
        x = x.flatten(2).transpose(1, 2)                 # row-major patches
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[2])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def vit_trainable_mask(vit: ViT, cfg: TeacherConfig) -> Dict[str, bool]:
    """Parameter name (relative to the ViT) -> trainable, as
    ``vit.vit_trainable_mask``: the reference trains what its timm name
    calls ``blocks.8``-``11`` or ``norm``, which unfreezes the last 4 blocks
    whole, ``norm1``/``norm2`` of every earlier block and the final norm;
    ``patch_embed``, ``cls_token`` and ``pos_embed`` stay frozen."""
    mask = {}
    for name, _ in vit.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            mask[name] = (int(parts[1]) >= cfg.encoder_depth - 4
                          or parts[2] in ("norm1", "norm2"))
        else:
            mask[name] = parts[0] == "norm"
    return mask
