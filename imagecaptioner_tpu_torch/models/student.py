"""The full CNN-LSTM student (``imagecaptioner_tpu/models/student.py``):
ResNet-50 -> 7x7 tokens -> Linear+ReLU+LayerNorm -> AttentionRefinement ->
2-layer LSTM decoder with Bahdanau attention.  Eval mode only.

Only ``variant="full"`` is ported; the compact and enhanced students are
ROADMAP Queue 1 items 7 and 8.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.modules import (LayerNorm, Linear,
                                                   MultiheadAttention,
                                                   adaptive_avg_pool2d,
                                                   layer_norm_init, linear_init,
                                                   mha_init)
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models.resnet import OUT_CHANNELS, ResNet50


def check_variant(cfg: StudentConfig) -> None:
    if cfg.variant != "full" or cfg.num_layers != 2:
        raise NotImplementedError(
            f"student variant {cfg.variant!r} with {cfg.num_layers} LSTM "
            "layers is not ported yet: the port serves the 2-layer full "
            "student (ROADMAP Queue 1: compact is item 7, enhanced item 8)")


class CNNEncoder(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        self.resnet = ResNet50()
        self.projection = nn.ModuleDict({
            "fc": Linear(OUT_CHANNELS, cfg.embed_size),
            "ln": LayerNorm(cfg.embed_size)})

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 49, E), tokens in row-major (h, w) order."""
        feats = adaptive_avg_pool2d(self.resnet(images), (7, 7))
        feats = feats.flatten(2).transpose(1, 2)             # (B, 49, 2048)
        x = torch.relu(self.projection.fc(feats))
        return self.projection.ln(x)


class AttentionRefinement(nn.Module):
    def __init__(self, embed_size: int, num_heads: int = 4):
        super().__init__()
        self.attention = MultiheadAttention(embed_size, num_heads)
        self.ffn = nn.ModuleDict({"fc1": Linear(embed_size, 2 * embed_size),
                                  "fc2": Linear(2 * embed_size, embed_size)})
        self.norm1 = LayerNorm(embed_size)
        self.norm2 = LayerNorm(embed_size)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        feats = self.norm1(feats + self.attention(feats, feats, feats))
        h = self.ffn.fc2(torch.relu(self.ffn.fc1(feats)))
        return self.norm2(feats + h)


class Student(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        check_variant(cfg)
        self.cfg = cfg
        self.encoder = CNNEncoder(cfg)
        self.attention_refinement = (AttentionRefinement(cfg.embed_size)
                                     if cfg.use_attention_refinement else None)
        self.decoder = L.FullDecoder(cfg)

    def encode_image(self, images: torch.Tensor, *, refine: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (raw_features, refined_features), both (B, 49, E)."""
        raw = self.encoder(images)
        refined = raw
        if refine and self.attention_refinement is not None:
            refined = self.attention_refinement(raw)
        return raw, refined

    def decoder_step(self, word_emb: torch.Tensor, hc, feats: torch.Tensor):
        """One recurrence step plus vocab logits: (logits, (h, c), attn)."""
        h_top, hc_new, attn = L.full_decoder_step(self.decoder, word_emb, hc,
                                                  feats)
        logits = L.output_projection(self.decoder.output_projection, h_top)
        return logits, hc_new, attn


def student_init(seed: int, cfg: StudentConfig):
    """Random (params, state) numpy trees in the layout of the JAX
    ``student_init``, drawn from ``np.random.default_rng(seed)``."""
    check_variant(cfg)
    rng = np.random.default_rng(seed)
    e = cfg.embed_size
    resnet_p, resnet_s = ResNet50.init(rng)
    params = {
        "encoder": {"resnet": resnet_p,
                    "projection": {"fc": linear_init(rng, OUT_CHANNELS, e),
                                   "ln": layer_norm_init(e)}},
        "decoder": L.FullDecoder.init(rng, cfg),
    }
    if cfg.use_attention_refinement:
        params["attention_refinement"] = {
            "attention": mha_init(rng, e),
            "ffn": {"fc1": linear_init(rng, e, 2 * e),
                    "fc2": linear_init(rng, 2 * e, e)},
            "norm1": layer_norm_init(e), "norm2": layer_norm_init(e)}
    return params, {"resnet": resnet_s}
