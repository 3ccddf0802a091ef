"""Attention core: softmax(q·kᵀ·scale [causal])·v, the port of
``imagecaptioner_tpu/ops/pallas_attention.py:fused_attention_core``.

Layouts: q (B, H, Lq, D), k and v (B, H, Lk, D).  q and k are promoted to
their result type; scores accumulate in float32, softmax runs in float32,
the probabilities are rounded to ``v.dtype`` before the product with v, and
the output is ``v.dtype`` (``pallas_attention.py:161-168``).

``attention_core`` dispatches on the device: a CPU tensor takes the plain
version (differentiable by ordinary autograd), a CUDA tensor the kernel in
``csrc/attention_core.cu`` (D = 64, Lk <= 256, Lq = Lk when causal), which
raises on anything it does not take.  The JAX package has no backward
kernel for this core: its ``custom_vjp`` recomputes the plain core and
differentiates that (``pallas_attention.py:_bwd``).  ``_AttentionCore`` does
the same around the CUDA forward.
"""

from __future__ import annotations

import ctypes

import torch

from imagecaptioner_tpu_torch.ops import _build

HEAD_DIM = 64
MAX_LK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by attention_core_cuda


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, scale: float = 1.0
                         ) -> torch.Tensor:
    """Plain PyTorch version (``attention_core_xla``)."""
    qk = torch.promote_types(q.dtype, k.dtype)
    s = torch.matmul(q.to(qk).float(), k.to(qk).float().transpose(-1, -2))
    s = s * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        row = torch.arange(lq, device=s.device)[:, None]
        col = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(col > row, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def attention_core_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float = 1.0
                        ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D CUDA tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported")
    qk = torch.promote_types(q.dtype, k.dtype)
    q, k = q.to(qk), k.to(qk)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D != HEAD_DIM or not 0 < Lk <= MAX_LK or Lq == 0:
        raise ValueError(f"kernel takes D={HEAD_DIM}, 0 < Lk <= {MAX_LK}; "
                         f"got D={D}, Lq={Lq}, Lk={Lk}")
    if causal and Lq != Lk:
        raise ValueError(f"kernel takes a causal mask only for Lq == Lk; "
                         f"got Lq={Lq}, Lk={Lk}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    out = torch.empty(q.shape, dtype=v.dtype, device=v.device)
    lib = _build.library("attention_core")
    fn = lib.ic_attention_core
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[qk], _DTYPES[v.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B * H, Lq, Lk, float(scale),
                 int(causal), stream)
    _build.check(lib, err, "attention_core")
    launches += 1
    return out


def attention_core_grads(q, k, v, g, *, causal: bool = False,
                         scale: float = 1.0, needs=(True, True, True)):
    """Gradients of the core with respect to q, k, v (None where not
    needed) for the output cotangent ``g``: recompute the plain core and
    differentiate it."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip((q, k, v), needs)]
    with torch.enable_grad():
        out = attention_core_plain(*leaves, causal=causal, scale=scale)
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class _AttentionCore(torch.autograd.Function):
    """The CUDA forward under autograd; the backward differentiates a
    recomputation of the plain core, as the JAX ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return attention_core_cuda(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return attention_core_grads(
            *ctx.saved_tensors, g, causal=ctx.causal, scale=ctx.scale,
            needs=ctx.needs_input_grad[:3]) + (None, None)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: float = 1.0) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _AttentionCore.apply(q, k, v, causal, scale)
        return attention_core_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"attention_core: unsupported device {q.device}")
