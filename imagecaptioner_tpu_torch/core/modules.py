"""Building blocks, the torch counterparts of ``imagecaptioner_tpu.core.modules``.

Parameters live in small ``nn.Module``s whose attribute names follow the JAX
parameter tree, so a converted JAX tree loads with ``strict=True``.  The
numerics follow the JAX functions: matmuls accumulate in float32 and add a
float32 bias before rounding to the activation dtype; layer norm runs in
float32; batch norm normalizes in float32, with the running statistics in
eval mode and the batch statistics (and torch's running-stat update) in
train mode.  Images are NCHW.  Parameters are created frozen
(``requires_grad=False``); a trainer turns on what it trains.

Convolutions, pooling and the plain projections stay ``F.conv2d`` /
``F.linear`` / ``F.max_pool2d``, as the JAX package leaves them to XLA.  The
attention core goes through ``ops.attention.attention_core``, the ported
kernel, never through ``scaled_dot_product_attention``.  A serving copy made
by ``ops/quant.py`` holds int8 weights: ``Linear`` and ``Conv2d`` dispatch on
``weight_q`` and ``multi_head_attention`` on ``in_proj_weight_q`` to the int8
products (``ops/int8.py``); the functional ``dense`` and ``conv2d`` take
float weights only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core.device import device_constant
from imagecaptioner_tpu_torch.ops import quant as Q
from imagecaptioner_tpu_torch.ops.attention import attention_core


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


# ---------------------------------------------------------------------------
# Functional forms
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W.T + b`` (weight torch-layout (out, in)) with float32
    accumulation and a float32 bias added before the one rounding to
    ``x.dtype``; the weight rides in the activation dtype as in
    ``modules.dense``.  A bf16 CUDA tensor multiplies its bf16 operands on
    tensor cores (``_DenseBf16``); elsewhere the operands are widened to
    float32 for the same values (a bf16 x bf16 product is exact in float32;
    the CPU has no bf16 product with a float32 result)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _DenseBf16.apply(x, weight, bias)
    w = weight.to(x.dtype).float()
    b = None if bias is None else bias.float()
    return F.linear(x.float(), w, b).to(x.dtype)


class _DenseBf16(torch.autograd.Function):
    """bf16 ``dense`` on the card: ``torch.addmm(b, x, Wᵀ, out_dtype=float32)``
    (bf16 operands, float32 accumulation and result, float32 bias), then one
    rounding to bf16, as JAX's ``dot_general(preferred_element_type=f32)``.
    The float32-result product has no autograd formula, so the backward is
    written out with the same products: dx = dtype(dy·W), dW = dtype(dyᵀ·x)
    widened to the weight's dtype (the gradient of its cast to bf16), db =
    sum of dy in float32; the same values as autograd through the
    float32 form."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(torch.bfloat16)
        x2 = x.reshape(-1, x.shape[-1])
        if bias is None:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = torch.addmm(bias.float(), x2, w.t(), out_dtype=torch.float32)
        ctx.save_for_backward(x2, w)
        ctx.shapes = x.shape, weight.dtype, None if bias is None else bias.dtype
        return y.to(torch.bfloat16).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        x_shape, w_dtype, b_dtype = ctx.shapes
        g = dy.reshape(-1, dy.shape[-1]).to(torch.bfloat16)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w, out_dtype=torch.float32).to(
                torch.bfloat16).reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(g.t(), x2, out_dtype=torch.float32).to(
                torch.bfloat16).to(w_dtype)
        if b_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(0).to(b_dtype)
        return dx, dw, db


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, weight)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NCHW conv with an (O, I/groups, kH, kW) weight; weight and bias ride
    in ``x.dtype``."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride, padding, 1, groups)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool = False, momentum: float = 0.1, eps: float = 1e-5
               ) -> torch.Tensor:
    """BatchNorm over NCHW, normalized in float32 and returned in
    ``x.dtype``.  Eval mode uses the running statistics.  Train mode uses
    the batch statistics (biased variance) and updates the running
    statistics in place with torch's rule: ``momentum`` and the unbiased
    batch variance, as ``modules.batch_norm`` does.  In train mode under a
    data-parallel world the statistics are the global batch's
    (``_GlobalBatchNorm``), as GSPMD's batch norm reduces over the whole
    batch axis."""
    if train and MS.data_size() > 1:
        return _GlobalBatchNorm.apply(x, weight, bias, running_mean,
                                      running_var, momentum, eps)
    if train:
        return F.batch_norm(x, running_mean, running_var, weight.float(),
                            bias.float(), True, momentum, eps)
    return F.batch_norm(x, running_mean.float(), running_var.float(),
                        weight.float(), bias.float(), False, 0.0, eps)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a data-parallel world
    (``nn.SyncBatchNorm``'s scheme, which refuses CPU tensors).  Forward:
    the sum and count, then the squared deviations from the global mean,
    each all-reduced (two passes); the running statistics take the global
    count's unbiased variance.  Backward: this rank's ``sum(dy)`` and
    ``sum(dy * xhat)`` are the weight's and bias's gradients (the train
    step all-reduces them with every other gradient); their all-reduced
    sums give the input's gradient.  The values are float32 and every sum
    accumulates in float64, as PyTorch's CPU batch norm accumulates."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        n_local = x.numel() // x.shape[1]
        f64 = torch.float64
        stats = torch.cat([xf.sum(dims, dtype=f64),
                           torch.full((1,), float(n_local), dtype=f64,
                                      device=x.device)])
        stats = MS.psum_over_data(stats)
        count = stats[-1]
        mean = stats[:-1] / count
        shape = [1, -1] + [1] * (x.dim() - 2)
        centered = xf - mean.float().view(shape)
        var = MS.psum_over_data(centered.square().sum(dims, dtype=f64)) \
            / count
        invstd = torch.rsqrt(var + eps).float()
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(
                (momentum * mean).to(running_mean.dtype))
            running_var.mul_(1.0 - momentum).add_(
                (momentum * var * count / (count - 1.0)).to(
                    running_var.dtype))
        xhat = centered * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, count)
        return (xhat * weight.float().view(shape)
                + bias.float().view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, invstd, count = ctx.saved_tensors
        dims = [0] + list(range(2, dy.dim()))
        shape = [1, -1] + [1] * (dy.dim() - 2)
        dyf = dy.float()
        sum_dy = dyf.sum(dims, dtype=torch.float64)
        sum_dy_xhat = (dyf * xhat).sum(dims, dtype=torch.float64)
        glob = MS.psum_over_data(torch.cat([sum_dy, sum_dy_xhat]))
        c = sum_dy.shape[0]
        mean_dy = (glob[:c] / count).float()
        mean_dy_xhat = (glob[c:] / count).float()
        dx = (weight.float() * invstd).view(shape) * (
            dyf - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
        return (dx.to(dy.dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None, None, None)


_DROPOUT_OFF = False


@contextlib.contextmanager
def no_dropout():
    """Make every ``dropout`` the identity inside the block while the models
    stay in train mode (batch norm keeps its batch statistics).  For parity
    checks: a CPU and a CUDA generator, or torch and jax.random, never draw
    the same masks."""
    global _DROPOUT_OFF
    old, _DROPOUT_OFF = _DROPOUT_OFF, True
    try:
        yield
    finally:
        _DROPOUT_OFF = old


def dropout_on(rate: float, train: bool) -> bool:
    """Whether a dropout of ``rate`` acts: train mode, a positive rate, and
    not inside ``no_dropout()``."""
    return train and rate > 0.0 and not _DROPOUT_OFF


def dropout_keep_mask(shape, rate: float, generator: Optional[torch.Generator],
                      device) -> torch.Tensor:
    """Boolean keep mask, True with probability ``1 - rate``, drawn from
    ``generator`` (which lives on ``device``)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when train=True "
                         "and rate > 0")
    return torch.rand(shape, generator=generator, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) at train time).  The keep mask is
    drawn from ``generator`` unless a ready boolean ``mask`` is given."""
    if not dropout_on(rate, train):
        return x
    if mask is None:
        mask = dropout_keep_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Standard sinusoidal table (max_len, d_model), float32 numpy."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


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


def _pool_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """``adaptive_pool_matrix`` as a float32 tensor on ``device``, uploaded
    once."""
    return device_constant(
        ("adaptive_pool", in_size, out_size),
        lambda: torch.from_numpy(adaptive_pool_matrix(in_size, out_size)),
        device)


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, C, L) -> (B, C, out_len) as one static matmul, torch
    AdaptiveAvgPool1d semantics."""
    m = _pool_matrix(x.shape[-1], out_len, x.device).to(x.dtype).float()
    return torch.einsum("ol,bcl->bco", m, x.float()).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """NCHW adaptive average pool as two static matmuls, rounded to the
    activation dtype in between as in ``modules.adaptive_avg_pool2d``."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == tuple(out_hw):
        return x  # both matrices are the identity
    mh = _pool_matrix(h, out_hw[0], x.device).to(x.dtype).float()
    mw = _pool_matrix(w, out_hw[1], x.device).to(x.dtype).float()
    y = torch.einsum("oh,bchw->bcow", mh, x.float()).to(x.dtype)
    return torch.einsum("pw,bcow->bcop", mw, y.float()).to(x.dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2).contiguous()


def multi_head_attention(p: "MultiheadAttention", query: torch.Tensor,
                         key: torch.Tensor, value: torch.Tensor, *,
                         num_heads: int, causal: bool = False,
                         dropout_rate: float = 0.0, train: bool = False,
                         generator: Optional[torch.Generator] = None,
                         need_weights: bool = False,
                         seq: Optional[Tuple[int, int]] = None):
    """nn.MultiheadAttention forward semantics (batch first): the packed
    ``in_proj`` split into q/k/v, heads split as ``modules._split_heads``,
    the ported attention core, ``out_proj``.  With dropout on the attention
    weights (train mode, rate > 0) the function is a different one than the
    kernel computes, and runs as plain tensor code, as in the JAX package;
    so does ``need_weights``, which returns ``(output, weights (B, Lq, Lk))``
    with the weights averaged over the heads *after* their dropout.

    A module placed by ``parallel/tp.py`` holds its heads' rows of the
    packed projection, ``num_heads`` of them, and a row-parallel
    ``out_proj``.  ``seq = (Lq, Lk)``: under the sequence policy
    (``parallel/sp.py``) query, key and value are this rank's blocks of
    token axes of Lq and Lk rows; the result is the rank's block of the
    output.  Without tensor parallelism each rank projects its own tokens,
    gathers K and V, and attends with its queries to all keys (causal: with
    its block's first row as ``q_offset``); with it, the sequences are
    gathered first and the row-parallel ``out_proj`` reduce-scatters."""
    q_offset = 0
    gather_kv = False
    if seq is not None:
        from imagecaptioner_tpu_torch.parallel import sp, tp

        if tp.is_placed(p.out_proj):
            same_q, same_v = query is key, value is key
            key = sp.gather_seq(key, 1, seq[1])
            query = key if same_q else sp.gather_seq(query, 1, seq[0])
            value = key if same_v else sp.gather_seq(value, 1, seq[1])
        else:
            gather_kv = True
            q_offset = sp.local_rows(seq[0])[0] if causal else 0
    e = query.shape[-1]
    if "in_proj_weight_q" in p._buffers:
        # one static scale for q, k and v: all three inputs are recorded
        for act in (query, key, value):
            Q.record_calibration_amax(p, act)
        q, k, v = (
            _split_heads(Q.in_proj_int8(p, x, slice(i * e, (i + 1) * e)),
                         num_heads)
            for i, x in enumerate((query, key, value)))
    else:
        w_q, w_k, w_v = p.in_proj_weight.chunk(3, dim=0)
        b_q, b_k, b_v = p.in_proj_bias.chunk(3, dim=0)
        q = _split_heads(dense(query, w_q, b_q), num_heads)  # (B, H, Lq, D)
        k = _split_heads(dense(key, w_k, b_k), num_heads)
        v = _split_heads(dense(value, w_v, b_v), num_heads)
    if gather_kv:
        k, v = sp.gather_seq(k, 2, seq[1]), sp.gather_seq(v, 2, seq[1])
    scale = 1.0 / math.sqrt(q.shape[-1])
    weights = None
    if need_weights or dropout_on(dropout_rate, train):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if causal:
            lq, lk = s.shape[-2], s.shape[-1]
            keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device
                              ).tril(q_offset)
            s = s.masked_fill(~keep, float("-inf"))
        w = dropout(torch.softmax(s, dim=-1), dropout_rate, train, generator)
        out = torch.matmul(w.to(v.dtype).float(), v.float()).to(v.dtype)
        weights = w.mean(dim=1)
    else:
        out = attention_core(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset)
    b, h, lq, d = out.shape
    out = p.out_proj(out.transpose(1, 2).reshape(b, lq, h * d))
    return (out, weights) if need_weights else out


# ---------------------------------------------------------------------------
# Parameter holders (names follow the JAX parameter tree)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features) if bias else None

    def forward(self, x):
        if "weight_q" in self._buffers:
            return Q.dense_int8(self, x)
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
    """Conv without a bias by default (no conv of ResNet-50 has one; the
    ViT's patch embedding does)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = False,
                 groups: int = 1):
        super().__init__()
        self.weight = _param(out_ch, in_ch // groups, kernel_size, kernel_size)
        self.bias = _param(out_ch) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        if "weight_q" in self._buffers:
            return Q.conv2d_int8(self, x)
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding, groups=self.groups)


class BatchNorm2d(nn.Module):
    """Batch norm in the module's mode (``train()`` / ``eval()``); the
    running statistics are buffers (the JAX package keeps them in a separate
    ``state`` tree) and update in train mode even when the affine parameters
    are frozen."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, train=self.training)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = _param(3 * embed_dim, embed_dim)
        self.in_proj_bias = _param(3 * embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, causal: bool = False,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                need_weights: bool = False,
                seq: Optional[Tuple[int, int]] = None):
        return multi_head_attention(
            self, query, key, value, num_heads=self.num_heads, causal=causal,
            dropout_rate=dropout_rate, train=self.training,
            generator=generator, need_weights=need_weights, seq=seq)


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
                kernel_size: int, bias: bool = False, groups: int = 1) -> dict:
    fan_in = (in_ch // groups) * kernel_size * kernel_size
    bound = 1.0 / math.sqrt(fan_in)
    p = {"weight": uniform_init(
        rng, (out_ch, in_ch // groups, kernel_size, kernel_size), bound)}
    if bias:
        p["bias"] = uniform_init(rng, (out_ch,), bound)
    return p


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
