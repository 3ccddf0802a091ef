"""The CNN-LSTM students (``imagecaptioner_tpu/models/student.py``):

* full: ResNet-50 -> 7x7 tokens -> Linear+ReLU+LayerNorm -> AttentionRefinement
  -> 2-layer LSTM decoder with Bahdanau attention;
* compact: MobileNetV2 -> 7x7 tokens -> Linear+ReLU -> optional 4-head
  refinement -> 1-layer LSTM with dot attention and additive fusion;
* enhanced: ``models/student_enhanced.py``.

``Student.forward`` is ``student_apply``: the teacher-forced forward in the
module's mode (``train()`` / ``eval()``), returning the reference 4-tuple.
Its feature tap is the *unrefined* encoder output for the full and compact
students and the compressed refined features for the enhanced one.
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
from imagecaptioner_tpu_torch.models import efficientnet, mobilenet
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models import student_enhanced as SE
from imagecaptioner_tpu_torch.models.resnet import OUT_CHANNELS, ResNet50

# LSTM layers the fused kernels of each variant take
VARIANT_LAYERS = {"full": 2, "compact": 1, "enhanced": 3}


def check_variant(cfg: StudentConfig) -> None:
    """Raise on what no kernel of the port takes: an unknown variant, or a
    layer count other than the variant's (2, 1 and 3 for full, compact and
    enhanced, as the JAX package's fused kernels)."""
    if cfg.variant not in VARIANT_LAYERS:
        raise ValueError(f"unknown student variant: {cfg.variant!r}")
    if cfg.num_layers != VARIANT_LAYERS[cfg.variant]:
        raise NotImplementedError(
            f"the {cfg.variant} student's kernels take "
            f"{VARIANT_LAYERS[cfg.variant]} LSTM layers, not {cfg.num_layers}")


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


class CompactEncoder(nn.Module):
    """MobileNetV2 -> 7x7 tokens -> Linear + ReLU + Dropout(0.1), no
    LayerNorm."""

    def __init__(self, cfg: StudentConfig):
        super().__init__()
        self.backbone = mobilenet.MobileNetV2()
        self.projection = nn.ModuleDict({
            "fc": Linear(mobilenet.OUT_CHANNELS, cfg.embed_size)})

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = adaptive_avg_pool2d(self.backbone(images), (7, 7))
        feats = feats.flatten(2).transpose(1, 2)             # (B, 49, 1280)
        return dropout(torch.relu(self.projection.fc(feats)), 0.1,
                       self.training, generator)


class CompactRefinement(nn.Module):
    """The compact variant's refinement: 4-head MHA + LayerNorm only."""

    def __init__(self, embed_size: int):
        super().__init__()
        self.attention = MultiheadAttention(embed_size, 4)
        self.norm = LayerNorm(embed_size)

    def forward(self, feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn_out = self.attention(feats, feats, feats, dropout_rate=0.1,
                                  generator=generator)
        return self.norm(feats + attn_out)


_ENCODERS = {"full": CNNEncoder, "compact": CompactEncoder,
             "enhanced": SE.EnhancedEncoder}
_REFINEMENTS = {"full": AttentionRefinement, "compact": CompactRefinement,
                "enhanced": SE.CrossRefinement}
_DECODERS = {"full": L.FullDecoder, "compact": L.CompactDecoder,
             "enhanced": SE.EnhancedDecoder}


class Student(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        check_variant(cfg)
        self.cfg = cfg
        self.encoder = _ENCODERS[cfg.variant](cfg)
        self.attention_refinement = (
            _REFINEMENTS[cfg.variant](cfg.embed_size)
            if cfg.use_attention_refinement else None)
        self.decoder = _DECODERS[cfg.variant](cfg)
        if cfg.variant == "enhanced":
            self.feature_compressor = SE.FeatureCompressor(cfg.embed_size)

    def encode_image(self, images: torch.Tensor, *, refine: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (raw_features, refined_features), both (B, L, E).  For
        the enhanced student "raw" is the compressed refined KD tap."""
        raw = self.encoder(images, generator)
        refined = raw
        enhanced = self.cfg.variant == "enhanced"
        if (refine or enhanced) and self.attention_refinement is not None:
            refined = self.attention_refinement(raw, generator)
        if enhanced:
            return self.feature_compressor(refined), refined
        return raw, refined

    def forward(self, images: torch.Tensor, captions: torch.Tensor, *,
                generator: Optional[torch.Generator] = None):
        """``student_apply``: images (B, 3, S, S), captions (T, B) ->
        (logits (T, B, V), encoder_features (B, L, E), hidden_states
        (T, B, H), attention_weights (T, B, L)).  ``encoder_features`` is the
        tap the KD loss reads.  In train mode batch norm uses and updates
        batch statistics and the dropouts draw from ``generator``."""
        raw, refined = self.encode_image(images, generator=generator)
        v = self.cfg.variant
        if v == "full":
            out = L.full_decoder_apply(
                self.decoder, refined, captions, self.cfg,
                train=self.training, generator=generator)
        elif v == "compact":
            out = L.compact_decoder_apply(self.decoder, refined, captions,
                                          self.cfg)
        else:
            out = SE.enhanced_decoder_apply(
                self.decoder, refined, captions, self.cfg,
                train=self.training, generator=generator)
        logits, hiddens, attns = out
        return logits, raw, hiddens, attns

    def decoder_step(self, word_emb: torch.Tensor, hc, feats: torch.Tensor):
        """One recurrence step plus vocab logits: (logits, (h, c), attn)."""
        v = self.cfg.variant
        if v == "enhanced":
            _, enh, hc_new, attn = SE.enhanced_decoder_step(
                self.decoder, word_emb, hc, feats, self.cfg)
            return (SE.enhanced_output_projection(self.decoder, enh, self.cfg),
                    hc_new, attn)
        if v == "full":
            h_top, hc_new, attn = L.full_decoder_step(self.decoder, word_emb,
                                                      hc, feats)
            return (L.output_projection(self.decoder.output_projection, h_top),
                    hc_new, attn)
        h_top, hc_new, attn = L.compact_decoder_step(self.decoder, word_emb,
                                                     hc, feats)
        return self.decoder.output_projection(h_top), hc_new, attn


FROZEN_RESNET = ("conv1.", "bn1.", "layer1.", "layer2.")


def frozen_prefixes(cfg: StudentConfig) -> Tuple[str, ...]:
    """Parameter-name prefixes that ``student_trainable_mask`` freezes: the
    ResNet's conv1, bn1, layer1 and layer2; MobileNetV2's first ten feature
    layers (both only with ``freeze_backbone``); EfficientNet-B3's stem and
    first four stages (always, as in the JAX package)."""
    if cfg.variant == "enhanced":
        return tuple(f"encoder.backbone.{k}"
                     for k in efficientnet.frozen_prefixes())
    if not cfg.freeze_backbone:
        return ()
    if cfg.variant == "full":
        return tuple(f"encoder.resnet.{k}" for k in FROZEN_RESNET)
    return tuple(f"encoder.backbone.{k}" for k in mobilenet.frozen_prefixes())


def student_trainable_mask(model: Student, cfg: StudentConfig
                           ) -> Dict[str, bool]:
    """Parameter name -> trainable, as ``student.student_trainable_mask``
    (frozen layers' batch-norm statistics still update in train mode)."""
    frozen = frozen_prefixes(cfg)
    return {name: not (frozen and name.startswith(frozen))
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
    if cfg.variant == "enhanced":
        return SE.enhanced_student_init(rng, cfg)
    if cfg.variant == "compact":
        backbone_p, backbone_s = mobilenet.MobileNetV2.init(rng)
        params = {
            "encoder": {"backbone": backbone_p,
                        "projection": {"fc": linear_init(
                            rng, mobilenet.OUT_CHANNELS, e)}},
            "decoder": L.CompactDecoder.init(rng, cfg)}
        if cfg.use_attention_refinement:
            params["attention_refinement"] = {
                "attention": mha_init(rng, e), "norm": layer_norm_init(e)}
        return params, {"backbone": backbone_s}
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
