"""The enhanced CNN-LSTM student
(``imagecaptioner_tpu/models/student_enhanced.py``): EfficientNet-B3 with a
spatial-attention gate and 8x8 = 64 tokens, a 2-layer cross-attention
refinement with learned positions and a global-context branch, and a decoder
of 8-head image attention with a learned query projection, gated word/context
fusion, a 3-layer LSTM stack with per-layer LayerNorm and dropout, and a
highway output gate.  Its KD feature tap is the *compressed refined*
features, unlike the other two students.

The teacher-forced forward (``enhanced_decoder_apply``) runs the recurrence
on ``ops/enhanced_scan.py``; the single step (``enhanced_decoder_step``) is
plain tensor code, for the serving loop and for the tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.modules import (Conv2d, Embedding,
                                                   LayerNorm, Linear,
                                                   MultiheadAttention, _param,
                                                   _split_heads,
                                                   adaptive_avg_pool2d,
                                                   conv2d_init, dense, dropout,
                                                   dropout_keep_mask,
                                                   dropout_on,
                                                   embedding_init, gelu,
                                                   layer_norm_init,
                                                   linear_init, mha_init,
                                                   multi_head_attention)
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models.efficientnet import (OUT_CHANNELS,
                                                          EfficientNetB3)
from imagecaptioner_tpu_torch.ops import enhanced_scan as ES

MAX_POS = 50        # learned sequence positions
NUM_HEADS = 8
ATTN_DROPOUT = 0.1  # dropout on the image attention's weights
TOKENS = 64


def _normal(rng: np.random.Generator, shape) -> np.ndarray:
    return (0.02 * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class EnhancedEncoder(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        e, d = cfg.embed_size, OUT_CHANNELS
        self.backbone = EfficientNetB3()
        self.spatial_attention = nn.ModuleDict({
            "conv1": Conv2d(d, d // 8, 1, bias=True),
            "conv2": Conv2d(d // 8, 1, 1, bias=True)})
        self.projection = nn.ModuleDict({
            "fc1": Linear(d, 2 * e), "fc2": Linear(2 * e, e),
            "ln": LayerNorm(e)})

    @staticmethod
    def init(rng: np.random.Generator, cfg: StudentConfig):
        e, d = cfg.embed_size, OUT_CHANNELS
        backbone_p, backbone_s = EfficientNetB3.init(rng)
        p = {"backbone": backbone_p,
             "spatial_attention": {
                 "conv1": conv2d_init(rng, d, d // 8, 1, bias=True),
                 "conv2": conv2d_init(rng, d // 8, 1, 1, bias=True)},
             "projection": {"fc1": linear_init(rng, d, 2 * e),
                            "fc2": linear_init(rng, 2 * e, e),
                            "ln": layer_norm_init(e)}}
        return p, {"backbone": backbone_s}

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 64, E), tokens in row-major (h, w) order."""
        x = self.backbone(images)
        attn = gelu(self.spatial_attention.conv1(x))
        x = x * torch.sigmoid(self.spatial_attention.conv2(attn))
        x = adaptive_avg_pool2d(x, (8, 8)).flatten(2).transpose(1, 2)
        h = dropout(gelu(self.projection.fc1(x)), 0.1, self.training, generator)
        return self.projection.ln(self.projection.fc2(h))


# ---------------------------------------------------------------------------
# Cross-attention refinement
# ---------------------------------------------------------------------------


class RefinementLayer(nn.Module):
    def __init__(self, e: int):
        super().__init__()
        self.attention = MultiheadAttention(e, NUM_HEADS)
        self.ffn = nn.ModuleDict({"fc1": Linear(e, 4 * e),
                                  "fc2": Linear(4 * e, e)})
        self.norm1 = LayerNorm(e)
        self.norm2 = LayerNorm(e)


class CrossRefinement(nn.Module):
    def __init__(self, e: int, num_layers: int = 2):
        super().__init__()
        self.pos_encoding = _param(1, TOKENS, e)
        self.layers = nn.ModuleList(RefinementLayer(e)
                                    for _ in range(num_layers))
        self.global_context = nn.ModuleDict({"fc1": Linear(e, e),
                                             "fc2": Linear(e, e)})

    @staticmethod
    def init(rng: np.random.Generator, e: int, num_layers: int = 2) -> dict:
        return {
            "pos_encoding": _normal(rng, (1, TOKENS, e)),
            "layers": [{"attention": mha_init(rng, e),
                        "ffn": {"fc1": linear_init(rng, e, 4 * e),
                                "fc2": linear_init(rng, 4 * e, e)},
                        "norm1": layer_norm_init(e),
                        "norm2": layer_norm_init(e)}
                       for _ in range(num_layers)],
            "global_context": {"fc1": linear_init(rng, e, e),
                               "fc2": linear_init(rng, e, e)}}

    def forward(self, feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = feats + self.pos_encoding.to(feats.dtype)
        for layer in self.layers:
            attn = layer.attention(x, x, x, dropout_rate=0.1,
                                   generator=generator)
            x = layer.norm1(x + attn)
            h = dropout(gelu(layer.ffn.fc1(x)), 0.1, self.training, generator)
            x = layer.norm2(x + layer.ffn.fc2(h))
        g = x.float().mean(dim=1).to(x.dtype)   # global context over tokens
        g = self.global_context.fc2(gelu(self.global_context.fc1(g)))
        return x + g[:, None, :]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class EnhancedDecoder(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        self.embedding = Embedding(v, e)
        self.pos_encoding = _param(1, MAX_POS, e)
        self.image_attention = MultiheadAttention(e, NUM_HEADS)
        self.query_projection = Linear(h, e)
        self.attention_gate = Linear(2 * e, e)
        self.lstm = nn.ModuleList(
            L.LSTMCell(e if i == 0 else h, h) for i in range(cfg.num_layers))
        self.lstm_norms = nn.ModuleList(LayerNorm(h)
                                        for _ in range(cfg.num_layers))
        self.highway_gate = Linear(h + e, h)
        self.highway_context_projection = Linear(e, h)
        self.output_projection = L.OutputProjection(h, e, v)

    @staticmethod
    def init(rng: np.random.Generator, cfg: StudentConfig) -> dict:
        """Random parameter tree in the layout of
        ``student_enhanced.enhanced_decoder_init``."""
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        return {
            "embedding": embedding_init(rng, v, e),
            "pos_encoding": _normal(rng, (1, MAX_POS, e)),
            "image_attention": mha_init(rng, e),
            "query_projection": linear_init(rng, h, e),
            "attention_gate": linear_init(rng, 2 * e, e),
            "lstm": L.lstm_stack_init(rng, e, h, cfg.num_layers),
            "lstm_norms": [layer_norm_init(h) for _ in range(cfg.num_layers)],
            "highway_gate": linear_init(rng, h + e, h),
            "highway_context_projection": linear_init(rng, e, h),
            "output_projection": {"fc1": linear_init(rng, h, e),
                                  "fc2": linear_init(rng, e, v)}}


def enhanced_decoder_step(p: EnhancedDecoder, word_emb: torch.Tensor, hc,
                          feats: torch.Tensor, cfg: StudentConfig, *,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None):
    """One recurrence step -> (h_top, enhanced_hidden, (h, c), attn_w); h and
    c are (layers, B, H)."""
    h, c = hc
    q = p.query_projection(h[-1])[:, None, :]
    ctx, w = multi_head_attention(
        p.image_attention, q, feats, feats, num_heads=NUM_HEADS,
        dropout_rate=ATTN_DROPOUT, train=train, generator=generator,
        need_weights=True)
    context, attn_w = ctx[:, 0, :], w[:, 0, :]
    gate = torch.sigmoid(p.attention_gate(torch.cat([word_emb, context], -1)))
    inp = gate * word_emb + (1.0 - gate) * context
    new_h, new_c = [], []
    for li, cell in enumerate(p.lstm):
        hi, ci = L.lstm_cell(cell, inp, h[li], c[li])
        hi = dropout(p.lstm_norms[li](hi), cfg.dropout, train, generator)
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
    ctx_h = p.highway_context_projection(context)
    hw = torch.sigmoid(p.highway_gate(torch.cat([inp, context], -1)))
    enhanced = hw * inp + (1.0 - hw) * ctx_h
    return inp, enhanced, (torch.stack(new_h), torch.stack(new_c)), attn_w


def enhanced_output_projection(p: EnhancedDecoder, enhanced: torch.Tensor,
                               cfg: StudentConfig, *, train: bool = False,
                               generator: Optional[torch.Generator] = None,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Linear(H->E) + GELU + Dropout + Linear(E->V), over (..., H)."""
    op = p.output_projection
    x = dropout(gelu(op.fc1(enhanced)), cfg.dropout, train, generator, mask)
    return op.fc2(x)


def enhanced_scan_weights(p: EnhancedDecoder, dt: torch.dtype):
    """The 23 weight operands of ``ops.enhanced_scan`` (``WEIGHTS``) from the
    decoder's parameters, as ``pallas_enhanced._split_enhanced_params`` but
    in torch layout and without the per-head split; differentiable back to
    the parameters."""
    if len(p.lstm) != ES.NUM_LAYERS:
        raise ValueError("the fused enhanced recurrence takes the 3-layer "
                         "stack")
    E = p.attention_gate.weight.shape[0]
    H = p.highway_gate.weight.shape[0]
    mha = p.image_attention
    w = lambda t: t.to(dt).contiguous()  # noqa: E731
    f = lambda t: t.float().contiguous()  # noqa: E731
    out = [w(p.query_projection.weight), f(p.query_projection.bias),
           w(mha.in_proj_weight[:E]), f(mha.in_proj_bias[:E]),
           w(mha.out_proj.weight), f(mha.out_proj.bias),
           w(p.attention_gate.weight[:, E:])]
    for cell in p.lstm:
        out += [w(cell.weight_ih), w(cell.weight_hh),
                f(cell.bias_ih + cell.bias_hh)]
    out += [f(torch.stack([n.weight for n in p.lstm_norms])),
            f(torch.stack([n.bias for n in p.lstm_norms])),
            w(p.highway_gate.weight[:, :H]), w(p.highway_gate.weight[:, H:]),
            f(p.highway_gate.bias), w(p.highway_context_projection.weight),
            f(p.highway_context_projection.bias)]
    return tuple(out)


def enhanced_decoder_apply(p: EnhancedDecoder, image_features: torch.Tensor,
                           captions: torch.Tensor, cfg: StudentConfig, *,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           masks: Optional[Dict[str, torch.Tensor]] = None):
    """Teacher-forced forward on the fused recurrence, as
    ``pallas_enhanced.pallas_enhanced_decoder_scan_train``.  captions (T, B)
    -> logits (T, B, V), hidden_states (T, B, H), attn (T, B, L) float32.

    The word embeddings with their learned positions, the word half of the
    attention gate, the per-head K and V and the vocab MLP are plain
    ``dense`` calls here; the recurrence is ``ops.enhanced_scan``.  In train
    mode the dropout multipliers are drawn from ``generator`` or taken ready
    from ``masks``: ``"attn"`` (T, B, nh, L) and ``"lstm"`` (3, T, B, H),
    float32 multipliers already divided by the keep probability, and
    ``"proj"``, a boolean keep mask (T, B, E)."""
    T, B = captions.shape
    E, H, nh = cfg.embed_size, cfg.hidden_size, NUM_HEADS
    dt, dev = image_features.dtype, image_features.device
    Lt = image_features.shape[1]
    masks = masks or {}

    emb = p.embedding(captions.t()).to(dt)                      # (B, T, E)
    n_pos = min(T, MAX_POS)
    emb = torch.cat([emb[:, :n_pos] + p.pos_encoding[:, :n_pos].to(dt),
                     emb[:, n_pos:]], dim=1)
    embp = emb.transpose(0, 1).contiguous()                     # (T, B, E)
    wg = p.attention_gate.weight
    gate_w = (torch.matmul(embp.float(), wg[:, :E].to(dt).float().t())
              + p.attention_gate.bias.float()).contiguous()
    mha = p.image_attention
    k = _split_heads(dense(image_features, mha.in_proj_weight[E:2 * E],
                           mha.in_proj_bias[E:2 * E]), nh)
    v = _split_heads(dense(image_features, mha.in_proj_weight[2 * E:],
                           mha.in_proj_bias[2 * E:]), nh)

    def multiplier(name, shape, rate):
        if not dropout_on(rate, train):
            return None
        m = masks.get(name)
        if m is None:
            m = dropout_keep_mask(shape, rate, generator, dev).float() \
                / (1.0 - rate)
        return m.float().contiguous()

    amask = multiplier("attn", (T, B, nh, Lt), ATTN_DROPOUT)
    lmask = multiplier("lstm", (ES.NUM_LAYERS, T, B, H), cfg.dropout)
    h_tops, enh, attn = ES.enhanced_decoder_scan(
        embp, gate_w, k, v, amask, lmask, *enhanced_scan_weights(p, dt))
    logits = enhanced_output_projection(p, enh, cfg, train=train,
                                        generator=generator,
                                        mask=masks.get("proj"))
    return logits, h_tops, attn


class FeatureCompressor(nn.Module):
    def __init__(self, e: int):
        super().__init__()
        self.fc1 = Linear(e, e // 2)
        self.fc2 = Linear(e // 2, e)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def enhanced_student_init(rng: np.random.Generator, cfg: StudentConfig
                          ) -> Tuple[dict, dict]:
    """Random (params, state) trees in the layout of
    ``student_enhanced.enhanced_student_init``."""
    e = cfg.embed_size
    enc_p, enc_s = EnhancedEncoder.init(rng, cfg)
    p = {"encoder": enc_p, "decoder": EnhancedDecoder.init(rng, cfg),
         "feature_compressor": {"fc1": linear_init(rng, e, e // 2),
                                "fc2": linear_init(rng, e // 2, e)}}
    if cfg.use_attention_refinement:
        p["attention_refinement"] = CrossRefinement.init(rng, e)
    return p, enc_s
