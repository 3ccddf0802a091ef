"""Transformer decoder with torch ``nn.TransformerDecoder`` semantics
(``imagecaptioner_tpu/models/transformer.py:51-110``): post-LN layers of
causal self-attention, cross-attention over the image memory and a ReLU FFN
(dim_feedforward = 2 x embed), batch first.

The incremental path with a KV cache and ancestry attention belongs to
teacher beam serving (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.modules import (LayerNorm, Linear,
                                                   MultiheadAttention, dropout,
                                                   layer_norm_init,
                                                   linear_init, mha_init)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.rate = dropout_rate
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.multihead_attn = MultiheadAttention(d_model, num_heads)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    @staticmethod
    def init(rng: np.random.Generator, d_model: int, dim_feedforward: int
             ) -> dict:
        return {"self_attn": mha_init(rng, d_model),
                "multihead_attn": mha_init(rng, d_model),
                "linear1": linear_init(rng, d_model, dim_feedforward),
                "linear2": linear_init(rng, dim_feedforward, d_model),
                "norm1": layer_norm_init(d_model),
                "norm2": layer_norm_init(d_model),
                "norm3": layer_norm_init(d_model)}

    def forward(self, x: torch.Tensor, memory: torch.Tensor, *,
                causal: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``decoder_layer_apply``: x (B, T, E), memory (B, L, E)."""
        drop = lambda t: dropout(t, self.rate, self.training, generator)  # noqa: E731
        sa = self.self_attn(x, x, x, causal=causal, dropout_rate=self.rate,
                            generator=generator)
        x = self.norm1(x + drop(sa))
        ca = self.multihead_attn(x, memory, memory, dropout_rate=self.rate,
                                 generator=generator)
        x = self.norm2(x + drop(ca))
        h = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm3(x + drop(h))


def decoder_apply(layers, x: torch.Tensor, memory: torch.Tensor, *,
                  causal: bool = True,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    for layer in layers:
        x = layer(x, memory, causal=causal, generator=generator)
    return x
