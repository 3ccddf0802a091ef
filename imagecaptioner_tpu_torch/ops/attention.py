"""Attention core: softmax(q·kᵀ·scale [causal])·v, the port of
``imagecaptioner_tpu/ops/pallas_attention.py:fused_attention_core``.

Layouts: q (B, H, Lq, D), k and v (B, H, Lk, D).  q and k are promoted to
their result type; scores accumulate in float32, softmax runs in float32,
the probabilities are rounded to ``v.dtype`` before the product with v, and
the output is ``v.dtype`` (``pallas_attention.py:161-168``).

``attention_core`` dispatches on the device: a CPU tensor takes the plain
version (differentiable by ordinary autograd), a CUDA tensor the kernel in
``csrc/attention_core.cu`` (D = 64 or 48, Lk <= 256; tensor cores, K and
V staged once per block), which raises on anything it does not take.  The
causal form takes a ``q_offset``: query row i sees keys ``<= i + q_offset``,
so that a rank of a sequence-parallel teacher (``parallel/sp.py``) runs its
block of caption positions ``[o, o + Lq)`` against all Lk keys with
``q_offset = o`` (``Lq + q_offset <= Lk``; 0 with Lq == Lk is the
full-length causal core).  ``attention_core_two_pass`` mirrors the kernel's
decomposition (score tiles, a two-pass softmax, P·V by key tiles) in plain
PyTorch for the CPU tests; nothing on the card calls it.  The JAX package
has no backward kernel for this core: its ``custom_vjp`` recomputes the
plain core and differentiates that (``pallas_attention.py:_bwd``).  ``_AttentionCore`` does
the same around the CUDA forward.

The JAX DP form, ``fused_attention_sharded`` (``pallas_attention.py:238``),
runs the kernel per batch shard under ``shard_map``.  Here each rank of a
data-parallel world (``core/mesh.py``) already holds only its rows, so it
calls this core on them; the replicated weights' gradients are summed by
the train step's all-reduce.  No other code path is needed.
"""

from __future__ import annotations

import ctypes

import torch

from imagecaptioner_tpu_torch.ops import _build

HEAD_DIMS = (64, 48)  # 48: the enhanced student's cross refinement, 384 / 8
MAX_LK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by attention_core_cuda
launches_offset = 0  # of them, causal ones on a block of rows (Lq < Lk)
_KERNEL = None  # (library, its entry point with argtypes set), at first use


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = _build.library("attention_core")
        fn = lib.ic_attention_core
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        _KERNEL = lib, fn
    return _KERNEL


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, scale: float = 1.0,
                         q_offset: int = 0,
                         acc_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch version (``attention_core_xla``).  ``acc_dtype`` is the
    type the sums run in (float64 shows what summation order alone moves);
    ``q_offset``: the causal mask's, as the kernel's."""
    qk = torch.promote_types(q.dtype, k.dtype)
    s = torch.matmul(q.to(qk).to(acc_dtype),
                     k.to(qk).to(acc_dtype).transpose(-1, -2))
    s = s * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        row = torch.arange(lq, device=s.device)[:, None]
        col = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(col > row + q_offset, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.to(acc_dtype), v.to(acc_dtype)).to(v.dtype)


def attention_core_two_pass(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            scale: float = 1.0, q_offset: int = 0,
                            key_tile: int = 8) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch: scores by tiles of
    ``key_tile`` keys (keys padded to a multiple of 16 and masked), pass 1
    the row max over all tiles and the row sum of exp(s - max), pass 2 the
    normalised probability rounded to ``v.dtype`` and P·V summed tile by
    tile in float32.  A test helper: nothing on the card calls it."""
    qk = torch.promote_types(q.dtype, k.dtype)
    qf, kf, vf = q.to(qk).float(), k.to(qk).float(), v.float()
    lq, lk = q.shape[-2], k.shape[-2]
    lkp = -(-lk // 16) * 16
    pad = (0, 0, 0, lkp - lk)
    kf, vf = torch.nn.functional.pad(kf, pad), torch.nn.functional.pad(vf, pad)
    row = torch.arange(lq)[:, None]
    tiles = []
    for j0 in range(0, lkp, key_tile):
        col = torch.arange(j0, j0 + key_tile)[None, :]
        s = torch.matmul(qf, kf[..., j0:j0 + key_tile, :].transpose(-1, -2))
        s = s * scale
        masked = (col >= lk) | ((col > row + q_offset) if causal else False)
        tiles.append(s.masked_fill(masked, float("-inf")))
    m = torch.stack([t.amax(-1) for t in tiles]).amax(0)[..., None]
    e = [torch.exp(t - m) for t in tiles]
    total = torch.stack([t.sum(-1) for t in e]).sum(0)[..., None]
    out = torch.zeros(qf.shape, dtype=torch.float32)
    for j, t in enumerate(e):
        p = (t / total).to(v.dtype).float()
        out = out + torch.matmul(p, vf[..., j * key_tile:(j + 1) * key_tile, :])
    return out.to(v.dtype)


def attention_core_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float = 1.0,
                        q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global launches, launches_offset
    if not (q.is_cuda and k.is_cuda and v.is_cuda) \
            or q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype not in _DTYPES:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: only "
                        "float32 and bfloat16 are supported")
    if q.dtype != k.dtype:
        qk = torch.promote_types(q.dtype, k.dtype)
        q, k = q.to(qk), k.to(qk)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS or not 0 < Lk <= MAX_LK or Lq == 0 or B * H == 0:
        raise ValueError(f"kernel takes D in {HEAD_DIMS}, 0 < Lk <= {MAX_LK}, "
                         f"a batch of heads; got D={D}, Lq={Lq}, Lk={Lk}, "
                         f"B*H={B * H}")
    if q_offset and not causal:
        raise ValueError("q_offset is the causal mask's")
    if causal and not (q_offset >= 0 and Lq + q_offset <= Lk):
        raise ValueError(f"kernel takes a causal mask for 0 <= q_offset and "
                         f"Lq + q_offset <= Lk; got Lq={Lq}, Lk={Lk}, "
                         f"q_offset={q_offset}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("q, k and v must be 16-byte aligned")
    dev = v.device
    if not (q.device == k.device == dev):
        raise ValueError("q, k and v must be on one device")
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    lib, fn = _kernel()
    err = _build.call_on(dev, fn, _DTYPES[q.dtype], _DTYPES[v.dtype], qp, kp,
                         vp, out.data_ptr(), B * H, Lq, Lk, D, float(scale),
                         int(causal), int(q_offset))
    _build.check(lib, err, "attention_core")
    launches += 1
    if causal and Lq < Lk:
        launches_offset += 1
    return out


def attention_core_grads(q, k, v, g, *, causal: bool = False,
                         scale: float = 1.0, q_offset: int = 0,
                         needs=(True, True, True)):
    """Gradients of the core with respect to q, k, v (None where not
    needed) for the output cotangent ``g``: recompute the plain core and
    differentiate it."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip((q, k, v), needs)]
    with torch.enable_grad():
        out = attention_core_plain(*leaves, causal=causal, scale=scale,
                                   q_offset=q_offset)
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class _AttentionCore(torch.autograd.Function):
    """The CUDA forward under autograd; the backward differentiates a
    recomputation of the plain core, as the JAX ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return attention_core_cuda(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        return attention_core_grads(
            *ctx.saved_tensors, g, causal=ctx.causal, scale=ctx.scale,
            q_offset=ctx.q_offset, needs=ctx.needs_input_grad[:3]) \
            + (None, None, None)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: float = 1.0,
                   q_offset: int = 0) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _AttentionCore.apply(q, k, v, causal, scale, q_offset)
        return attention_core_cuda(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset)
    raise ValueError(f"attention_core: unsupported device {q.device}")
