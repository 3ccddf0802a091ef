"""Full-student LSTM decoder (``imagecaptioner_tpu/models/lstm.py``).

Torch LSTM semantics: gate order (i, f, g, o), two bias vectors.  These
step functions follow the JAX scan path's numerics (h and c rounded to the
activation dtype after every step); the serving loop itself is
``ops/greedy.py``, which keeps h and c in float32 as the fused kernel does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.modules import (Embedding, Linear, _param,
                                                   dense, embedding_init,
                                                   linear_init, orthogonal,
                                                   xavier_uniform)


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
        lstm = []
        for i in range(cfg.num_layers):
            lstm.append({
                "weight_ih": xavier_uniform(rng, (4 * h, e if i == 0 else h)),
                "weight_hh": orthogonal(rng, (4 * h, h)),
                "bias_ih": np.zeros(4 * h, np.float32),
                "bias_hh": np.zeros(4 * h, np.float32)})
        return {
            "embedding": embedding_init(rng, v, e),
            "attention": linear_init(rng, h + e, e),
            "attention_combine": linear_init(rng, 2 * e, e),
            "lstm": lstm,
            "output_projection": {"fc1": linear_init(rng, h, e),
                                  "fc2": linear_init(rng, e, v)},
        }


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


def output_projection(p: OutputProjection, h_top: torch.Tensor
                      ) -> torch.Tensor:
    """Linear(H->E) + ReLU + Linear(E->V) (eval: no dropout)."""
    x = torch.relu(dense(h_top, p.fc1.weight, p.fc1.bias))
    return dense(x, p.fc2.weight, p.fc2.bias)
