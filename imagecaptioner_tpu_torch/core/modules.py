"""Building blocks, the torch counterparts of ``imagecaptioner_tpu.core.modules``.

Parameters live in small ``nn.Module``s whose attribute names follow the JAX
parameter tree, so a converted JAX tree loads with ``strict=True``.  The
numerics follow the JAX functions: matmuls accumulate in float32 and add a
float32 bias before rounding to the activation dtype; layer norm runs in
float32; batch norm (eval) normalizes in float32.  Images are NCHW.

Convolutions, pooling and the plain projections stay ``F.conv2d`` /
``F.linear`` / ``F.max_pool2d``, as the JAX package leaves them to XLA.  The
attention core goes through ``ops.attention.attention_core``, the ported
kernel, never through ``scaled_dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioner_tpu_torch.ops.attention import attention_core


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


# ---------------------------------------------------------------------------
# Functional forms
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W.T + b`` (weight torch-layout (out, in)) with float32
    accumulation and a float32 bias; the weight rides in the activation dtype
    as in ``modules.dense``."""
    w = weight.to(x.dtype).float()
    b = None if bias is None else bias.float()
    return F.linear(x.float(), w, b).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, weight)


def conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Bias-free NCHW conv with an OIHW weight; the weight rides in
    ``x.dtype``."""
    return F.conv2d(x, weight.to(x.dtype), None, stride, padding)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over NCHW: normalized in float32 with the running
    statistics, returned in ``x.dtype``."""
    return F.batch_norm(x, running_mean.float(), running_var.float(),
                        weight.float(), bias.float(), False, 0.0, eps)


def max_pool2d(x: torch.Tensor, window: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)


def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Averaging matrix (out, in) with torch AdaptiveAvgPool semantics:
    bin i covers [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """NCHW adaptive average pool as two static matmuls, rounded to the
    activation dtype in between as in ``modules.adaptive_avg_pool2d``."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == tuple(out_hw):
        return x  # both matrices are the identity
    mh = torch.from_numpy(adaptive_pool_matrix(h, out_hw[0])).to(x.device)
    mw = torch.from_numpy(adaptive_pool_matrix(w, out_hw[1])).to(x.device)
    mh = mh.to(x.dtype).float()
    mw = mw.to(x.dtype).float()
    y = torch.einsum("oh,bchw->bcow", mh, x.float()).to(x.dtype)
    return torch.einsum("pw,bcow->bcop", mw, y.float()).to(x.dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2).contiguous()


def multi_head_attention(p: "MultiheadAttention", query: torch.Tensor,
                         key: torch.Tensor, value: torch.Tensor, *,
                         num_heads: int, causal: bool = False) -> torch.Tensor:
    """nn.MultiheadAttention forward semantics (batch first, eval): the
    packed ``in_proj`` split into q/k/v, heads split as
    ``modules._split_heads``, the ported attention core, ``out_proj``."""
    e = query.shape[-1]
    w_q, w_k, w_v = p.in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = p.in_proj_bias.chunk(3, dim=0)
    q = _split_heads(dense(query, w_q, b_q), num_heads)     # (B, H, Lq, D)
    k = _split_heads(dense(key, w_k, b_k), num_heads)
    v = _split_heads(dense(value, w_v, b_v), num_heads)
    out = attention_core(q, k, v, causal=causal,
                         scale=1.0 / math.sqrt(e // num_heads))
    b, h, lq, d = out.shape
    out = out.transpose(1, 2).reshape(b, lq, h * d)
    return p.out_proj(out)


# ---------------------------------------------------------------------------
# Parameter holders (names follow the JAX parameter tree)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features) if bias else None

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.weight = _param(num_embeddings, dim)

    def forward(self, ids):
        return embedding(self.weight, ids)


class Conv2d(nn.Module):
    """Bias-free conv (no conv of ResNet-50 has one)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = _param(out_ch, in_ch, kernel_size, kernel_size)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class BatchNorm2d(nn.Module):
    """Eval-mode batch norm; the running statistics are buffers (the JAX
    package keeps them in a separate ``state`` tree)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = _param(3 * embed_dim, embed_dim)
        self.in_proj_bias = _param(3 * embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, causal: bool = False):
        return multi_head_attention(self, query, key, value,
                                    num_heads=self.num_heads, causal=causal)


# ---------------------------------------------------------------------------
# Random initialization from a numpy generator, as JAX-layout parameter
# trees with PyTorch-default bounds (``modules.linear_init`` and friends).
# The port's serving smoke run builds a full student from a seed this way.
# ---------------------------------------------------------------------------


def uniform_init(rng: np.random.Generator, shape, bound: float) -> np.ndarray:
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def xavier_uniform(rng: np.random.Generator, shape) -> np.ndarray:
    return uniform_init(rng, shape, math.sqrt(6.0 / (shape[0] + shape[1])))


def orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    n_rows, n_cols = shape
    q, r = np.linalg.qr(rng.standard_normal((max(shape), min(shape))))
    q = q * np.sign(np.diagonal(r))
    q = q[:n_rows, :n_cols] if n_rows >= n_cols else q[:n_cols, :n_rows].T
    return q.astype(np.float32)


def linear_init(rng: np.random.Generator, in_features: int,
                out_features: int) -> dict:
    """nn.Linear default: weight and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_features)
    return {"weight": uniform_init(rng, (out_features, in_features), bound),
            "bias": uniform_init(rng, (out_features,), bound)}


def conv2d_init(rng: np.random.Generator, in_ch: int, out_ch: int,
                kernel_size: int) -> dict:
    fan_in = in_ch * kernel_size * kernel_size
    return {"weight": uniform_init(
        rng, (out_ch, in_ch, kernel_size, kernel_size), 1.0 / math.sqrt(fan_in))}


def batch_norm_init(num_features: int):
    return ({"weight": np.ones(num_features, np.float32),
             "bias": np.zeros(num_features, np.float32)},
            {"running_mean": np.zeros(num_features, np.float32),
             "running_var": np.ones(num_features, np.float32)})


def layer_norm_init(dim: int) -> dict:
    return {"weight": np.ones(dim, np.float32),
            "bias": np.zeros(dim, np.float32)}


def embedding_init(rng: np.random.Generator, num: int, dim: int) -> dict:
    return {"weight": uniform_init(rng, (num, dim), 0.1)}


def mha_init(rng: np.random.Generator, embed_dim: int) -> dict:
    return {"in_proj_weight": xavier_uniform(rng, (3 * embed_dim, embed_dim)),
            "in_proj_bias": np.zeros(3 * embed_dim, np.float32),
            "out_proj": {"weight": uniform_init(rng, (embed_dim, embed_dim),
                                                1.0 / math.sqrt(embed_dim)),
                         "bias": np.zeros(embed_dim, np.float32)}}


def cast_parameters(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating parameters (not buffers) in place, as
    ``core/precision.bf16_compute`` casts the parameter tree while the
    batch-norm state stays float32."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
