"""The full CNN-LSTM student (``imagecaptioner_tpu/models/student.py``):
ResNet-50 -> 7x7 tokens -> Linear+ReLU+LayerNorm -> AttentionRefinement ->
2-layer LSTM decoder with Bahdanau attention.  ``Student.forward`` is
``student_apply``: the teacher-forced forward in the module's mode
(``train()`` / ``eval()``), returning the reference 4-tuple with the
*unrefined* feature tap.

Only ``variant="full"`` is ported; the compact and enhanced students are
ROADMAP Queue 1 items 7 and 8.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.modules import (LayerNorm, Linear,
                                                   MultiheadAttention,
                                                   adaptive_avg_pool2d,
                                                   dropout, layer_norm_init,
                                                   linear_init, mha_init)
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

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 49, E), tokens in row-major (h, w) order."""
        feats = adaptive_avg_pool2d(self.resnet(images), (7, 7))
        feats = feats.flatten(2).transpose(1, 2)             # (B, 49, 2048)
        x = torch.relu(self.projection.fc(feats))
        x = dropout(x, 0.2, self.training, generator)
        return self.projection.ln(x)


class AttentionRefinement(nn.Module):
    def __init__(self, embed_size: int, num_heads: int = 4):
        super().__init__()
        self.attention = MultiheadAttention(embed_size, num_heads)
        self.ffn = nn.ModuleDict({"fc1": Linear(embed_size, 2 * embed_size),
                                  "fc2": Linear(2 * embed_size, embed_size)})
        self.norm1 = LayerNorm(embed_size)
        self.norm2 = LayerNorm(embed_size)

    def forward(self, feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn_out = self.attention(feats, feats, feats, dropout_rate=0.1,
                                  generator=generator)
        feats = self.norm1(feats + attn_out)
        h = dropout(torch.relu(self.ffn.fc1(feats)), 0.1, self.training,
                    generator)
        return self.norm2(feats + self.ffn.fc2(h))


class Student(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        check_variant(cfg)
        self.cfg = cfg
        self.encoder = CNNEncoder(cfg)
        self.attention_refinement = (AttentionRefinement(cfg.embed_size)
                                     if cfg.use_attention_refinement else None)
        self.decoder = L.FullDecoder(cfg)

    def encode_image(self, images: torch.Tensor, *, refine: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (raw_features, refined_features), both (B, 49, E)."""
        raw = self.encoder(images, generator)
        refined = raw
        if refine and self.attention_refinement is not None:
            refined = self.attention_refinement(raw, generator)
        return raw, refined

    def forward(self, images: torch.Tensor, captions: torch.Tensor, *,
                generator: Optional[torch.Generator] = None):
        """``student_apply``: images (B, 3, S, S), captions (T, B) ->
        (logits (T, B, V), encoder_features (B, L, E), hidden_states
        (T, B, H), attention_weights (T, B, L)).  ``encoder_features`` is the
        *unrefined* tap the KD loss reads.  In train mode batch norm uses
        and updates batch statistics and the dropouts draw from
        ``generator``."""
        raw, refined = self.encode_image(images, generator=generator)
        logits, hiddens, attns = L.full_decoder_apply(
            self.decoder, refined, captions, self.cfg, train=self.training,
            generator=generator)
        return logits, raw, hiddens, attns

    def decoder_step(self, word_emb: torch.Tensor, hc, feats: torch.Tensor):
        """One recurrence step plus vocab logits: (logits, (h, c), attn)."""
        h_top, hc_new, attn = L.full_decoder_step(self.decoder, word_emb, hc,
                                                  feats)
        logits = L.output_projection(self.decoder.output_projection, h_top)
        return logits, hc_new, attn


FROZEN_BACKBONE = ("conv1", "bn1", "layer1", "layer2")


def student_trainable_mask(model: Student, cfg: StudentConfig
                           ) -> Dict[str, bool]:
    """Parameter name -> trainable, as ``student.student_trainable_mask``:
    with ``freeze_backbone`` the ResNet's conv1, bn1, layer1 and layer2 are
    frozen (their batch-norm statistics still update in train mode)."""
    frozen = tuple(f"encoder.resnet.{k}." for k in FROZEN_BACKBONE)
    return {name: not (cfg.freeze_backbone and name.startswith(frozen))
            for name, _ in model.named_parameters()}


def set_trainable(model: Student, cfg: StudentConfig) -> Dict[str, bool]:
    """Apply ``student_trainable_mask`` as ``requires_grad``."""
    mask = student_trainable_mask(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


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
