"""The full student in plain float32 PyTorch: ResNet-50 (v1.5, stride on
the 3x3) -> 7x7 tokens -> Linear + ReLU + LayerNorm -> a 4-head attention
refinement -> a 2-layer LSTM with Bahdanau attention, teacher-forced.

``W`` maps the port's parameter names to float32 tensors; ``r`` rounds
every product's operands (``precision.py``).  ``drop(shape, rate)`` gives
the inverted-dropout factor of each dropout in train mode (keep / (1 - p)),
or is None in eval mode.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.precision import Rounding, f32

START, END, PAD = 1, 2, 0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
Drop = Optional[Callable[[tuple, float], torch.Tensor]]


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, ImageNet mean and std."""
    x = images_u8.float() / 255.0
    m = torch.tensor(MEAN, device=x.device)
    s = torch.tensor(STD, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def linear(x, W, name, r: Rounding = f32, bias: bool = True):
    y = r(x) @ r(W[name + ".weight"]).t()
    return y + W[name + ".bias"] if bias else y


def layer_norm(x, W, name, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * W[name + ".weight"] \
        + W[name + ".bias"]


def _batch_norm(x, W, name, train: bool, eps: float = 1e-5,
               record: Optional[dict] = None):
    """Batch statistics in train mode (kept in ``record`` by name when
    given), the running statistics in eval mode."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if record is not None:
            record[name] = (mean, var)
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
            * W[name + ".weight"].view(shape) + W[name + ".bias"].view(shape))


def resnet50(x, W, p: str, r: Rounding = f32, train: bool = False,
             record: Optional[dict] = None):
    """(B, 3, H, W) -> (B, 2048, H/32, W/32)."""
    def conv(x, name, stride=1, pad=0):
        return F.conv2d(r(x), r(W[name + ".weight"]), None, stride, pad)

    def batch_norm(x, W, name, train):
        return _batch_norm(x, W, name, train, record=record)
    x = F.relu(batch_norm(conv(x, p + "conv1", 2, 3), W, p + "bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (blocks, _, stride) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            b = f"{p}layer{li}.{bi}."
            st = stride if bi == 0 else 1
            y = F.relu(batch_norm(conv(x, b + "conv1"), W, b + "bn1", train))
            y = F.relu(batch_norm(conv(y, b + "conv2", st, 1), W, b + "bn2",
                                  train))
            y = batch_norm(conv(y, b + "conv3"), W, b + "bn3", train)
            if b + "downsample.conv.weight" in W:
                x = batch_norm(conv(x, b + "downsample.conv", st), W,
                               b + "downsample.bn", train)
            x = F.relu(y + x)
    return x


@torch.no_grad()
def calibrate_bn(W, images_u8, p: str = "encoder.resnet.") -> None:
    """Set every batch norm's running statistics to the batch statistics
    of ``images_u8``, as training leaves them: a random ResNet with unit
    statistics maps all images to nearly one feature.  A variance is held
    to at least a tenth of its layer's median, so that a channel the batch
    leaves nearly constant does not amplify rounding a hundredfold."""
    stats: dict = {}
    resnet50(normalize(images_u8), W, p, train=True, record=stats)
    for name, (mean, var) in stats.items():
        W[name + ".running_mean"] = mean
        W[name + ".running_var"] = var.clamp(min=0.1 * float(var.median()))


def dropped(x, rate: float, drop: Drop):
    return x if drop is None else x * drop(tuple(x.shape), rate)


def mha(q_in, kv_in, W, name, heads: int, r: Rounding = f32,
        causal: bool = False, drop: Drop = None):
    """nn.MultiheadAttention (batch first) over the packed in-projection;
    dropout on the attention weights when ``drop`` is given."""
    e = q_in.shape[-1]
    w, b = W[name + ".in_proj_weight"], W[name + ".in_proj_bias"]
    q = r(q_in) @ r(w[:e]).t() + b[:e]
    k = r(kv_in) @ r(w[e:2 * e]).t() + b[e:2 * e]
    v = r(kv_in) @ r(w[2 * e:]).t() + b[2 * e:]

    def heads_of(t):
        return t.reshape(t.shape[0], t.shape[1], heads, e // heads
                         ).transpose(1, 2)
    q, k, v = heads_of(q), heads_of(k), heads_of(v)
    s = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(e // heads)
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    a = dropped(torch.softmax(s, dim=-1), 0.1, drop)
    o = (r(a) @ r(v)).transpose(1, 2).reshape(q_in.shape[0], -1, e)
    return linear(o, W, name + ".out_proj", r)


def encode(images, W, r: Rounding = f32, train: bool = False,
           drop: Drop = None, refine: bool = True):
    """Normalized images -> (raw (B, 49, E), refined (B, 49, E))."""
    f = resnet50(images, W, "encoder.resnet.", r, train)
    f = F.adaptive_avg_pool2d(f, (7, 7)).flatten(2).transpose(1, 2)
    x = F.relu(linear(f, W, "encoder.projection.fc", r))
    raw = layer_norm(dropped(x, 0.2, drop), W, "encoder.projection.ln")
    if not refine:
        return raw, raw
    p = "attention_refinement."
    a = mha(raw, raw, W, p + "attention", 4, r, drop=drop)
    h = layer_norm(raw + a, W, p + "norm1")
    ff = dropped(F.relu(linear(h, W, p + "ffn.fc1", r)), 0.1, drop)
    return raw, layer_norm(h + linear(ff, W, p + "ffn.fc2", r), W, p + "norm2")


def decode(feats, tokens_in, W, r: Rounding = f32, drop: Drop = None,
           rate: float = 0.0):
    """Teacher-forced decoder: feats (B, L, E), tokens_in (B, T) ->
    logits (B, T, V).  In train mode the layer-0 output fed to layer 1 and
    the head's hidden layer drop at ``rate``."""
    p = "decoder."
    B, T = tokens_in.shape
    E = feats.shape[-1]
    w_attn = W[p + "attention.weight"]
    H = w_attn.shape[1] - E
    w_comb = W[p + "attention_combine.weight"]
    f_proj = r(feats) @ r(w_attn[:, H:]).t() + W[p + "attention.bias"]
    emb = W[p + "embedding.weight"][tokens_in]                 # (B, T, E)
    emb_w = r(emb) @ r(w_comb[:, :E]).t() + W[p + "attention_combine.bias"]
    lw = [(r(W[f"{p}lstm.{i}.weight_ih"]).t(), r(W[f"{p}lstm.{i}.weight_hh"]).t(),
           W[f"{p}lstm.{i}.bias_ih"] + W[f"{p}lstm.{i}.bias_hh"])
          for i in range(2)]
    w_h, w_c = r(w_attn[:, :H]).t(), r(w_comb[:, E:]).t()

    def cell(x, h, c, i):
        wi, wh, b = lw[i]
        gi, gf, gg, go = (r(x) @ wi + r(h) @ wh + b).chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        return torch.sigmoid(go) * torch.tanh(c), c

    z = feats.new_zeros(B, H)
    h0 = c0 = h1 = c1 = z
    keep = None if drop is None else drop((T, B, H), rate)
    tops = []
    for t in range(T):
        scores = torch.tanh(f_proj + (r(h1) @ w_h)[:, None, :]).sum(-1)
        attn = torch.softmax(scores, dim=-1)
        ctx = (attn[:, :, None] * feats).sum(1)
        x0 = emb_w[:, t] + r(ctx) @ w_c
        h0, c0 = cell(x0, h0, c0, 0)
        fed = h0 if keep is None else h0 * keep[t]
        h1, c1 = cell(fed, h1, c1, 1)
        tops.append(h1)
    h_tops = torch.stack(tops, 1)                              # (B, T, H)
    hid = F.relu(linear(h_tops, W, p + "output_projection.fc1", r))
    if drop is not None:
        hid = hid * drop((T, B, hid.shape[-1]), rate).transpose(0, 1)
    return linear(hid, W, p + "output_projection.fc2", r), h_tops


def served_targets(tokens: torch.Tensor):
    """A greedy decode's output (B, T), PAD at and after the first END ->
    (inputs (B, T): START then the served tokens, targets (B, T): the
    served tokens with END where the first PAD is, valid (B, T): up to and
    including that END)."""
    B, T = tokens.shape
    is_pad = tokens == PAD
    first = torch.where(is_pad.any(1), is_pad.float().argmax(1),
                        torch.full((B,), T, device=tokens.device))
    pos = torch.arange(T, device=tokens.device)[None]
    targets = torch.where(pos == first[:, None], END, tokens.long())
    inputs = torch.cat([torch.full((B, 1), START, device=tokens.device,
                                   dtype=torch.long), targets[:, :-1]], 1)
    return inputs, targets, pos <= first[:, None]


@torch.no_grad()
def greedy_gaps(W: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                tokens: torch.Tensor, r: Rounding = f32,
                block: int = 16) -> torch.Tensor:
    """For each served token, by how much its logit lies below the
    reference's best at that position (0 where it is the reference's
    argmax); -inf where nothing was served.  Blocks of ``block`` images."""
    out = []
    for s in range(0, images_u8.shape[0], block):
        _, refined = encode(normalize(images_u8[s:s + block]), W, r)
        inputs, targets, valid = served_targets(tokens[s:s + block])
        logits, _ = decode(refined, inputs, W, r)
        gap = logits.max(-1).values - logits.gather(
            -1, targets[..., None]).squeeze(-1)
        out.append(torch.where(valid, gap, float("-inf")))
    return torch.cat(out)
