"""Full- and compact-student LSTM decoders
(``imagecaptioner_tpu/models/lstm.py``).

Torch LSTM semantics: gate order (i, f, g, o), two bias vectors.  The
step functions follow the JAX scan path's numerics (h and c rounded to the
activation dtype after every step); the serving loops are ``ops/greedy.py``
and the teacher-forced training forwards (``full_decoder_apply``,
``compact_decoder_apply``) run on ``ops/lstm_scan.py``; those keep h and c
in float32 as the fused kernels do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.modules import (Embedding, Linear, _param,
                                                   dense, dropout,
                                                   dropout_keep_mask,
                                                   dropout_on,
                                                   embedding_init,
                                                   linear_init, orthogonal,
                                                   xavier_uniform)
from imagecaptioner_tpu_torch.ops.lstm_scan import (compact_decoder_scan,
                                                    decoder_scan)


class LSTMCell(nn.Module):
    """One layer's parameters in torch layout: w_ih (4H, in), w_hh (4H, H)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.weight_ih = _param(4 * hidden_size, input_size)
        self.weight_hh = _param(4 * hidden_size, hidden_size)
        self.bias_ih = _param(4 * hidden_size)
        self.bias_hh = _param(4 * hidden_size)


class OutputProjection(nn.Module):
    def __init__(self, hidden: int, embed: int, vocab: int):
        super().__init__()
        self.fc1 = Linear(hidden, embed)
        self.fc2 = Linear(embed, vocab)


class FullDecoder(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        self.embedding = Embedding(v, e)
        self.attention = Linear(h + e, e)
        self.attention_combine = Linear(2 * e, e)
        self.lstm = nn.ModuleList(
            LSTMCell(e if i == 0 else h, h) for i in range(cfg.num_layers))
        self.output_projection = OutputProjection(h, e, v)

    @staticmethod
    def init(rng: np.random.Generator, cfg: StudentConfig) -> dict:
        """Random parameter tree in the layout of ``lstm.full_decoder_init``
        (xavier w_ih, orthogonal w_hh, zero biases)."""
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        lstm = lstm_stack_init(rng, e, h, cfg.num_layers)  # drawn first
        return {
            "embedding": embedding_init(rng, v, e),
            "attention": linear_init(rng, h + e, e),
            "attention_combine": linear_init(rng, 2 * e, e),
            "lstm": lstm,
            "output_projection": {"fc1": linear_init(rng, h, e),
                                  "fc2": linear_init(rng, e, v)},
        }


def lstm_stack_init(rng: np.random.Generator, input_size: int,
                    hidden_size: int, num_layers: int) -> list:
    """``lstm.lstm_stack_init``: xavier w_ih, orthogonal w_hh, zero biases."""
    h = hidden_size
    return [{"weight_ih": xavier_uniform(rng, (4 * h, input_size if i == 0
                                               else h)),
             "weight_hh": orthogonal(rng, (4 * h, h)),
             "bias_ih": np.zeros(4 * h, np.float32),
             "bias_hh": np.zeros(4 * h, np.float32)}
            for i in range(num_layers)]


def init_hidden(num_layers: int, batch: int, hidden: int, dtype, device):
    z = torch.zeros((num_layers, batch, hidden), dtype=dtype, device=device)
    return z, z


def lstm_cell(p: LSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One torch-semantics LSTM cell step. x (B, in), h/c (B, H)."""
    dt = x.dtype
    gates = (torch.matmul(x.float(), p.weight_ih.to(dt).float().t())
             + torch.matmul(h.to(dt).float(), p.weight_hh.to(dt).float().t())
             + p.bias_ih.float() + p.bias_hh.float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def bahdanau_attention(p: Linear, h_top: torch.Tensor, feats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Additive attention: scores = sum_E tanh(Linear([h, feats])), softmax
    over the L tokens.  h_top (B, H), feats (B, L, E) -> context (B, E),
    weights (B, L)."""
    B, L, _ = feats.shape
    combined = torch.cat([h_top[:, None, :].expand(B, L, h_top.shape[1]),
                          feats], dim=-1)
    scores = torch.tanh(p(combined)).sum(-1)
    weights = torch.softmax(scores.float(), dim=1).to(feats.dtype)
    context = torch.einsum("bl,ble->be", weights.float(), feats.float())
    return context.to(feats.dtype), weights


def full_decoder_step(p: FullDecoder, word_emb: torch.Tensor, hc,
                      feats: torch.Tensor):
    """One recurrence step without the vocab projection; h and c are
    (layers, B, H).  Returns (h_top, (h, c), attn_w)."""
    h, c = hc
    context, attn_w = bahdanau_attention(p.attention, h[-1], feats)
    inp = p.attention_combine(torch.cat([word_emb, context], dim=-1))
    new_h, new_c = [], []
    for li, cell in enumerate(p.lstm):
        hi, ci = lstm_cell(cell, inp, h[li], c[li])
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
    return inp, (torch.stack(new_h), torch.stack(new_c)), attn_w


def output_projection(p: OutputProjection, h_top: torch.Tensor, *,
                      rate: float = 0.0, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear(H->E) + ReLU + Dropout + Linear(E->V), over (..., H) of any
    rank: hoisted out of the recurrence for (T, B, H)."""
    x = torch.relu(dense(h_top, p.fc1.weight, p.fc1.bias))
    x = dropout(x, rate, train, generator, mask)
    return dense(x, p.fc2.weight, p.fc2.bias)


def decoder_scan_weights(p: FullDecoder, dt: torch.dtype):
    """The eight weight operands of ``ops.lstm_scan.decoder_scan`` from the
    decoder's parameters (``pallas_lstm._split_params``): w_h and w_c are
    column slices of the packed attention / combine weights, the biases the
    float32 sums b_ih + b_hh; differentiable back to the parameters."""
    if len(p.lstm) != 2:
        raise ValueError("the fused recurrence takes the 2-layer full decoder")
    H = p.lstm[0].weight_hh.shape[1]
    E = p.attention_combine.weight.shape[0]
    l0, l1 = p.lstm
    w = lambda t: t.to(dt).contiguous()  # noqa: E731
    return (p.attention.weight.to(dt)[:, :H],
            p.attention_combine.weight.to(dt)[:, E:],
            w(l0.weight_ih), w(l0.weight_hh), (l0.bias_ih + l0.bias_hh).float(),
            w(l1.weight_ih), w(l1.weight_hh), (l1.bias_ih + l1.bias_hh).float())


def full_decoder_apply(p: FullDecoder, image_features: torch.Tensor,
                       captions: torch.Tensor, cfg: StudentConfig, *,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       masks: Optional[Dict[str, torch.Tensor]] = None):
    """Teacher-forced forward on the fused recurrence, as
    ``pallas_lstm.pallas_full_decoder_scan_train``.  captions (T, B) ->
    logits (T, B, V), hidden_states (T, B, H), attn (T, B, L) float32.

    ``f_proj`` and ``emb_w`` are computed here as plain matmuls, the
    recurrence by ``ops.lstm_scan.decoder_scan``, the vocab projection over
    (T, B, H) at once.  In train mode the inter-layer mask (T, B, H) and the
    projection's keep mask are drawn from ``generator``, or taken ready from
    ``masks`` (``"lstm"``: boolean keep mask (T, B, H); ``"proj"``: boolean
    keep mask (T, B, E))."""
    weights = decoder_scan_weights(p, image_features.dtype)
    T, B = captions.shape
    E, H = cfg.embed_size, cfg.hidden_size
    dt = image_features.dtype
    feats = image_features.contiguous()
    masks = masks or {}
    mask = None
    if dropout_on(cfg.dropout, train):
        keep = masks.get("lstm")
        if keep is None:
            keep = dropout_keep_mask((T, B, H), cfg.dropout, generator,
                                     feats.device)
        mask = (keep.float() / (1.0 - cfg.dropout)).contiguous()
    w_attn, w_comb = p.attention.weight, p.attention_combine.weight
    f_proj = dense(feats, w_attn[:, H:], p.attention.bias)
    emb = p.embedding(captions).to(dt)
    emb_w = dense(emb, w_comb[:, :E], p.attention_combine.bias)
    h_tops, attn = decoder_scan(emb_w.contiguous(), f_proj.contiguous(),
                                feats, mask, *weights)
    logits = output_projection(p.output_projection, h_tops, rate=cfg.dropout,
                               train=train, generator=generator,
                               mask=masks.get("proj"))
    return logits, h_tops, attn


# ---------------------------------------------------------------------------
# Compact-student decoder: dot attention, additive fusion, a plain Linear
# head, no dropout anywhere
# ---------------------------------------------------------------------------


class CompactDecoder(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        self.embedding = Embedding(v, e)
        self.attention = Linear(h, e)
        self.lstm = nn.ModuleList(
            LSTMCell(e if i == 0 else h, h) for i in range(cfg.num_layers))
        self.output_projection = Linear(h, v)

    @staticmethod
    def init(rng: np.random.Generator, cfg: StudentConfig) -> dict:
        """Random parameter tree in the layout of
        ``lstm.compact_decoder_init``."""
        e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
        return {"embedding": embedding_init(rng, v, e),
                "attention": linear_init(rng, h, e),
                "lstm": lstm_stack_init(rng, e, h, cfg.num_layers),
                "output_projection": linear_init(rng, h, v)}


def dot_attention(p: Linear, h_top: torch.Tensor, feats: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dot-product attention: scores = (W h + b) . feats, softmax over the L
    tokens.  h_top (B, H), feats (B, L, E) -> context (B, E), weights (B, L)."""
    h_proj = p(h_top)
    scores = torch.einsum("be,ble->bl", h_proj.float(), feats.float())
    weights = torch.softmax(scores, dim=1).to(feats.dtype)
    context = torch.einsum("bl,ble->be", weights.float(), feats.float())
    return context.to(feats.dtype), weights


def compact_decoder_step(p: CompactDecoder, word_emb: torch.Tensor, hc,
                         feats: torch.Tensor):
    """One recurrence step without the vocab projection; h and c are
    (layers, B, H).  Returns (h_top, (h, c), attn_w)."""
    h, c = hc
    context, attn_w = dot_attention(p.attention, h[-1], feats)
    inp = word_emb + context
    new_h, new_c = [], []
    for li, cell in enumerate(p.lstm):
        hi, ci = lstm_cell(cell, inp, h[li], c[li])
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
    return inp, (torch.stack(new_h), torch.stack(new_c)), attn_w


def compact_scan_weights(p: CompactDecoder, dt: torch.dtype):
    """The five weight operands of ``ops.lstm_scan.compact_decoder_scan``
    from the decoder's parameters; differentiable back to them."""
    if len(p.lstm) != 1:
        raise ValueError("the fused compact recurrence takes the 1-layer "
                         "decoder")
    l0 = p.lstm[0]
    return (p.attention.weight.to(dt).contiguous(), p.attention.bias.float(),
            l0.weight_ih.to(dt).contiguous(), l0.weight_hh.to(dt).contiguous(),
            (l0.bias_ih + l0.bias_hh).float())


def compact_decoder_apply(p: CompactDecoder, image_features: torch.Tensor,
                          captions: torch.Tensor, cfg: StudentConfig):
    """Teacher-forced forward on the fused recurrence, as
    ``pallas_lstm.pallas_compact_decoder_scan_train``.  captions (T, B) ->
    logits (T, B, V), hidden_states (T, B, H), attn (T, B, L) float32."""
    dt = image_features.dtype
    emb = p.embedding(captions).to(dt).contiguous()
    h_tops, attn = compact_decoder_scan(
        emb, image_features.contiguous(), *compact_scan_weights(p, dt))
    return p.output_projection(h_tops), h_tops, attn
