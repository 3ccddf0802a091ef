"""Transformer decoder with torch ``nn.TransformerDecoder`` semantics
(``imagecaptioner_tpu/models/transformer.py:51-110``): post-LN layers of
causal self-attention, cross-attention over the image memory and a ReLU FFN
(dim_feedforward = 2 x embed), batch first.

The incremental path (``init_kv_cache``, ``precompute_memory_kv``,
``decoder_step_cached``) runs one token through all layers over a head-major
KV cache, so greedy and beam decoding never re-run the prefix.  It updates
the cache in place: the JAX arrays are immutable, these buffers are not, and
a step writes one row of each.  With an ancestry table (beam search) the
self- and cross-attention cores are the kernels of ``ops/beam_attn.py``;
without one (greedy) they are plain tensor code, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.modules import (LayerNorm, Linear,
                                                   MultiheadAttention, dropout,
                                                   dense, layer_norm_init,
                                                   linear_init, mha_init)
from imagecaptioner_tpu_torch.ops import quant as Q
from imagecaptioner_tpu_torch.ops.attention import attention_core_plain
from imagecaptioner_tpu_torch.ops.beam_attn import (beam_cross_attention,
                                                    beam_self_attention)
from imagecaptioner_tpu_torch.parallel import sp, tp

KVCache = List[Dict[str, torch.Tensor]]


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
                generator: Optional[torch.Generator] = None,
                seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``decoder_layer_apply``: x (B, T, E), memory (B, L, E).
        ``seq = (T, L)``: under the sequence policy x and memory are this
        rank's blocks of those token axes (``parallel/sp.py``); the norms
        stay on the rank's rows, the attentions read the whole memory and
        the whole caption stream, and with a layer placed by
        ``parallel/tp.py`` the FFN gathers the stream before its
        column-parallel ``linear1``."""
        drop = lambda t: dropout(t, self.rate, self.training, generator)  # noqa: E731
        sa = self.self_attn(x, x, x, causal=causal, dropout_rate=self.rate,
                            generator=generator,
                            seq=None if seq is None else (seq[0], seq[0]))
        x = self.norm1(x + drop(sa))
        ca = self.multihead_attn(x, memory, memory, dropout_rate=self.rate,
                                 generator=generator, seq=seq)
        x = self.norm2(x + drop(ca))
        h = x
        if seq is not None and tp.is_placed(self.linear2):
            h = sp.gather_seq(h, 1, seq[0])
        h = self.linear2(drop(torch.relu(self.linear1(h))))
        return self.norm3(x + drop(h))


def decoder_apply(layers, x: torch.Tensor, memory: torch.Tensor, *,
                  causal: bool = True,
                  generator: Optional[torch.Generator] = None,
                  seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    for layer in layers:
        x = layer(x, memory, causal=causal, generator=generator, seq=seq)
    return x


# ---------------------------------------------------------------------------
# Incremental decoding with a KV cache (greedy and beam loops)
# ---------------------------------------------------------------------------


def init_kv_cache(num_layers: int, batch: int, max_len: int, d_model: int,
                  dtype: torch.dtype = torch.float32, *, num_heads: int = 1,
                  device=None) -> KVCache:
    """Per-layer list of {'k', 'v'} zero buffers, each head-major
    (batch, num_heads, max_len, hd): the layout the attention cores read."""
    shape = (batch, num_heads, max_len, d_model // num_heads)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(num_layers)]


def _proj_qkv(mha: MultiheadAttention, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed in-projection of x (B, L, E) as one product; q, k and v
    are its column blocks (views, each element what a separate product would
    give).  A quantized in-projection is one int8 product."""
    if "in_proj_weight_q" in mha._buffers:
        return Q.in_proj_int8(mha, x, slice(None)).chunk(3, dim=-1)
    return dense(x, mha.in_proj_weight, mha.in_proj_bias).chunk(3, dim=-1)


def _proj_q(mha: MultiheadAttention, x: torch.Tensor) -> torch.Tensor:
    """Q-only projection for cross-attention decode steps: the query
    token's K and V are never used there.  A quantized in-projection
    records x against the packed weight, as JAX does."""
    if "in_proj_weight_q" in mha._buffers:
        e = mha.in_proj_weight_q.shape[1]
        return Q.in_proj_int8(mha, x, slice(0, e))
    e = mha.in_proj_weight.shape[1]
    return dense(x, mha.in_proj_weight[:e], mha.in_proj_bias[:e])


def _head_major(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = t.shape
    return t.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def precompute_memory_kv(layers, memory: torch.Tensor, *, num_heads: int = 1
                         ) -> KVCache:
    """Cross-attention K/V depend only on the encoder memory (B, L, E):
    computed once per decode, stored head-major (B, H, L, hd)."""
    cached = []
    for layer in layers:
        _, k, v = _proj_qkv(layer.multihead_attn, memory)
        cached.append({"k": _head_major(k, num_heads).contiguous(),
                       "v": _head_major(v, num_heads).contiguous()})
    return cached


def _attend_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """Attention of a few query rows q (B, Lq, E) over head-major k, v
    (B, H, S, hd), unmasked: plain tensor code."""
    b, lq, e = q.shape
    out = attention_core_plain(_head_major(q, num_heads), k, v,
                               scale=1.0 / (e // num_heads) ** 0.5)
    return out.transpose(1, 2).reshape(b, lq, e)


def decoder_step_cached(layers, x_t: torch.Tensor, pos: int,
                        self_kv: KVCache, mem_kv: KVCache, *, num_heads: int,
                        mem_group: int = 1,
                        anc: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, KVCache]:
    """One token through all layers with KV caching (eval mode, no dropout).

    x_t (B, 1, E); ``pos`` the host loop's counter; ``self_kv`` per-layer
    {'k', 'v'} head-major (B, H, S, hd), written in place at ``pos`` and
    returned.  ``mem_group`` consecutive rows of x_t share one row of
    ``mem_kv`` (beam search packs an image's K beams at rows n*K..n*K+K-1).
    ``anc`` (N, K, S) int32 is the beam-ancestry table: the cache stays
    un-reordered and ``anc[n, i, s]`` names the slot whose position-s entry
    belongs to the beam now in slot i.  With ``anc`` the two attention cores
    are ``ops.beam_attn``'s; without it self-attention reads positions
    0..pos of the row's own cache.
    """
    B, _, E = x_t.shape
    hd = E // num_heads
    y = x_t
    for layer, kv, mkv in zip(layers, self_kv, mem_kv):
        q, k_new, v_new = _proj_qkv(layer.self_attn, y)
        kv["k"][:, :, pos] = k_new.reshape(B, num_heads, hd)
        kv["v"][:, :, pos] = v_new.reshape(B, num_heads, hd)
        if anc is not None:
            sa = beam_self_attention(q, kv, anc, pos, num_heads=num_heads)
        else:
            sa = _attend_hm(q, kv["k"][:, :, :pos + 1], kv["v"][:, :, :pos + 1],
                            num_heads)
        y = layer.norm1(y + layer.self_attn.out_proj(sa))

        qc = _proj_q(layer.multihead_attn, y)
        if anc is not None:
            ca = beam_cross_attention(qc, mkv, mem_group=mem_group,
                                      num_heads=num_heads)
        elif mem_group > 1:
            qg = qc.reshape(-1, mem_group, E)                 # (N, K, E)
            ca = _attend_hm(qg, mkv["k"], mkv["v"], num_heads).reshape(B, 1, E)
        else:
            ca = _attend_hm(qc, mkv["k"], mkv["v"], num_heads)
        y = layer.norm2(y + layer.multihead_attn.out_proj(ca))

        h = layer.linear2(torch.relu(layer.linear1(y)))
        y = layer.norm3(y + h)
    return y, self_kv
