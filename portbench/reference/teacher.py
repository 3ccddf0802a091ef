"""The teacher in plain float32 PyTorch: ViT-S/16 (pre-norm blocks, exact
GELU, final LayerNorm) -> Linear 384 -> 512 -> a post-LN causal
transformer decoder (ReLU FFN) over sinusoidal position encodings ->
LayerNorm -> the head; the score of a beam hypothesis under it, and a
plain beam search.
``W`` maps the port's parameter names to float32 tensors (the teacher's
own names; ``p`` prefixes them)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Rounding, f32
from portbench.reference.student import (END, START, layer_norm, linear,
                                         mha, normalize)


def vit(x, W, heads: int, r: Rounding = f32, p: str = "encoder."):
    """(B, 3, S, S) -> (B, 1 + (S/16)^2, d)."""
    w = W[p + "patch_embed.proj.weight"]
    x = F.conv2d(r(x), r(w), W[p + "patch_embed.proj.bias"], w.shape[-1])
    x = x.flatten(2).transpose(1, 2)
    cls = W[p + "cls_token"].expand(x.shape[0], 1, x.shape[2])
    x = torch.cat([cls, x], 1) + W[p + "pos_embed"]
    depth = len({k.split(".")[2] for k in W if k.startswith(p + "blocks.")})
    d = x.shape[-1]
    for i in range(depth):
        b = f"{p}blocks.{i}."
        h = layer_norm(x, W, b + "norm1")
        qkv = linear(h, W, b + "attn.qkv", r).reshape(
            x.shape[0], x.shape[1], 3, heads, d // heads)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = torch.softmax((r(q) @ r(k).transpose(-1, -2))
                          / math.sqrt(d // heads), dim=-1)
        o = (r(a) @ r(v)).transpose(1, 2).reshape(x.shape)
        x = x + linear(o, W, b + "attn.proj", r)
        h = layer_norm(x, W, b + "norm2")
        x = x + linear(F.gelu(linear(h, W, b + "mlp.fc1", r)), W,
                       b + "mlp.fc2", r)
    return layer_norm(x, W, p + "norm")


def encode_image(images, W, cfg: dict, r: Rounding = f32):
    """Normalized images -> the decoder's memory (B, 197, E); ``cfg`` is
    the configuration's ``teacher`` group."""
    f = vit(images, W, cfg["encoder_heads"], r)
    if "encoder_projection.weight" in W:
        f = linear(f, W, "encoder_projection", r)
    return f


def positions(T: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table's first T rows (float32)."""
    pos = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * np.float32(-math.log(10000.0) / d))
    pe = np.zeros((T, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def decode(memory, tokens_in, W, heads: int, r: Rounding = f32):
    """Teacher-forced, eval mode: tokens_in (B, T) -> logits (B, T, V)."""
    x = W["embedding.weight"][tokens_in]
    x = x + positions(x.shape[1], x.shape[2], x.device)[None]
    layers = len({k.split(".")[1] for k in W if k.startswith("decoder.")})
    for i in range(layers):
        b = f"decoder.{i}."
        x = layer_norm(x + mha(x, x, W, b + "self_attn", heads, r,
                               causal=True), W, b + "norm1")
        x = layer_norm(x + mha(x, memory, W, b + "multihead_attn", heads, r),
                       W, b + "norm2")
        ff = linear(F.relu(linear(x, W, b + "linear1", r)), W, b + "linear2", r)
        x = layer_norm(x + ff, W, b + "norm3")
    return linear(layer_norm(x, W, "pre_output_norm"), W, "fc_out", r)


def length_penalty(length: int, alpha: float = 0.6) -> float:
    """GNMT ((5 + length) / 6) ** alpha, in float32."""
    return float(np.float32((5.0 + length) / 6.0) ** np.float32(alpha))


@torch.no_grad()
def beam_scores(W: Dict[str, torch.Tensor], cfg: dict, images_u8, seqs,
                lens, r: Rounding = f32, block: int = 8) -> torch.Tensor:
    """The length-normalized log-probability of each hypothesis: seqs
    (N, K, S) with START first, lens (N, K) counting START and END (0 for
    none).  Returns (N, K), NaN where lens is 0."""
    N, K, S = seqs.shape
    out = torch.full((N, K), float("nan"), device=seqs.device)
    for s in range(0, N, block):
        memory = encode_image(normalize(images_u8[s:s + block]), W, cfg, r)
        n = memory.shape[0]
        mem = memory[:, None].expand(n, K, *memory.shape[1:]).reshape(
            n * K, *memory.shape[1:])
        toks = seqs[s:s + block].reshape(n * K, S).long()
        logp = torch.log_softmax(
            decode(mem, toks[:, :-1], W, cfg["num_heads"], r), -1)
        tok_lp = logp.gather(-1, toks[:, 1:, None]).squeeze(-1)   # (nK, S-1)
        ln = lens[s:s + block].reshape(n * K).long()
        upto = torch.arange(1, S, device=seqs.device)[None] < ln[:, None]
        total = (tok_lp * upto).sum(-1)
        pen = torch.tensor([length_penalty(int(v)) for v in ln.tolist()],
                           device=seqs.device)
        out[s:s + block] = torch.where(ln > 0, total / pen,
                                       float("nan")).reshape(n, K)
    return out


def ended(seqs, lens) -> torch.Tensor:
    """Whether each hypothesis ends in END at position lens - 1."""
    idx = (lens.long() - 1).clamp(min=0)[..., None]
    return seqs.long().gather(-1, idx).squeeze(-1) == END


@torch.no_grad()
def beam_search(W: Dict[str, torch.Tensor], cfg: dict, images_u8, K: int,
                max_length: int, r: Rounding = f32) -> torch.Tensor:
    """Each image's best length-normalized score under a plain beam search
    of ``K`` beams and ``max_length`` steps, every prefix decoded anew.

    A step extends every live beam by every word and keeps the best
    ``K - finished`` candidates, best first: a candidate ending in END
    finishes with its score over the penalty of its length (START and END
    counted), the rest live on.  The search stops when no beam lives.  The
    result is the best finished score, or, where none finished, the best
    live score over the penalty of ``max_length + 1``.  Returns (N,)."""
    memory = encode_image(normalize(images_u8), W, cfg, r)
    N = memory.shape[0]
    live = [[([START], 0.0)] for _ in range(N)]
    fin = [[] for _ in range(N)]
    for t in range(max_length):
        rows = [(i, toks, sc) for i in range(N) for toks, sc in live[i]]
        if not rows:
            break
        idx = torch.tensor([i for i, _, _ in rows], device=memory.device)
        toks = torch.tensor([tk for _, tk, _ in rows], device=memory.device)
        logp = torch.log_softmax(
            decode(memory[idx], toks, W, cfg["num_heads"], r)[:, -1], -1)
        cand = torch.tensor([sc for _, _, sc in rows], device=memory.device
                            )[:, None] + logp
        V = cand.shape[1]
        at = 0
        for i in range(N):
            n = len(live[i])
            width = K - len(fin[i])
            if n == 0:
                continue
            top, pos = torch.topk(cand[at:at + n].reshape(-1), width)
            beams, live[i] = live[i], []
            for sc, p in zip(top.tolist(), pos.tolist()):
                word = p % V
                prefix = beams[p // V][0]
                if word == END:
                    fin[i].append(sc / length_penalty(t + 2))
                else:
                    live[i].append((prefix + [word], sc))
            at += n
    best = [max(fin[i]) if fin[i] else
            max(sc for _, sc in live[i]) / length_penalty(max_length + 1)
            for i in range(N)]
    return torch.tensor(best, dtype=torch.float64)
