"""Attention cores of one beam-search decode step, the ports of
``imagecaptioner_tpu/ops/pallas_beam_attn.py``: ``fused_beam_self_attention``
and ``fused_beam_cross_attention``.

Layouts are the JAX functions': q (R, 1, E) with R = N*K, an image's K beams
in consecutive rows; the self-attention cache ``kv`` = {'k', 'v'} head-major
(R, H, S, hd) with this step's rows already written at ``pos``; ``anc``
(N, K, S) int32, the slot whose position-s entry belongs to the beam now in
slot i (identity at ``pos``); the memory ``mem_kv`` = {'k', 'v'} head-major
(N, H, L, hd).  Scores accumulate in float32 and are scaled after the dot,
softmax runs in float32, the weights are rounded to the cache's dtype before
the product with v, the context accumulates in float32, and the output
(R, 1, E) has the cache's dtype.

``beam_self_attention`` and ``beam_cross_attention`` dispatch on the device:
a CPU tensor takes the plain version, a CUDA tensor the kernel in
``csrc/beam_attention.cu`` (hd = 64, S <= 64, L <= 256, float32 or bfloat16,
the cache and the memory 16-byte aligned), which raises on anything it does
not take.  The self kernel takes any K: ``self_plan`` says how a launch is
cut into blocks and chunks of staged rows.
The kernels read q through its row stride, so q may be a column block of a
packed projection.  Serving only: no gradient, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops.attention import attention_core_plain

HEAD_DIM = 64
MAX_S = 64     # cache positions the self kernel takes
MAX_L = 256    # memory tokens the cross kernel takes
MAX_KG = 8     # beams a block of the self kernel (a warp each)
SELF_SMEM = 232448  # the H100's opt-in shared memory a block, the self budget
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SCALE = 1.0 / HEAD_DIM ** 0.5

launches_self = 0   # kernel launches by beam_self_attention_cuda
launches_cross = 0  # kernel launches by beam_cross_attention_cuda
_KERNELS = None  # (library, its entry points with argtypes set), at first use


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        lib = _build.library("beam_attention")
        fns = {"self": lib.ic_beam_self_attention,
               "cross": lib.ic_beam_cross_attention}
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        fns["self"].argtypes = [i, p, i, p, p, p, p, i, i, i, i, i, i, f, p]
        fns["cross"].argtypes = [i, p, i, p, p, p, i, i, i, i, i, f, p]
        for fn in fns.values():
            fn.restype = ctypes.c_int
        _KERNELS = lib, fns
    return _KERNELS


def self_plan(K: int, pos: int, dtype: torch.dtype) -> Dict[str, int]:
    """How the self kernel cuts a launch (``csrc/beam_attention.cu``
    ``self_plan``): ``beams`` a block (an image's K beams in ``groups``
    blocks a head), its k and v rows staged in ``chunks`` of ``slots`` slots
    x ``positions`` positions, and the dynamic shared ``smem`` bytes a
    block: two mbarriers, the beams' q rows, a table of 64 (row, weight)
    pairs a beam and two buffers of slots x positions rows."""
    item = torch.tensor([], dtype=dtype).element_size()
    length = pos + 1
    kg = min(K, MAX_KG)
    fixed = 16 + kg * (HEAD_DIM * item + MAX_S * 8)
    pair = 2 * HEAD_DIM * item
    rows = (SELF_SMEM - fixed) // pair
    slots = min(K, rows)
    positions = min(length, rows // slots)
    return dict(beams=kg, groups=-(-K // kg), slots=slots, positions=positions,
                chunks=-(-K // slots) * -(-length // positions),
                smem=fixed + pair * slots * positions)


def self_plan_built(K: int, pos: int, dtype: torch.dtype) -> Dict[str, int]:
    """The built library's own plan (``ic_beam_self_plan``), with the keys
    of ``self_plan``: the two must agree.  A check, not a launch path."""
    lib = _kernels()[0]
    fn = lib.ic_beam_self_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    _build.check(lib, fn(_DTYPES[dtype], K, pos, out), "beam_self_plan")
    return dict(zip(("beams", "groups", "slots", "positions", "chunks",
                     "smem"), out))


def beam_self_attention_plain(q: torch.Tensor, kv: Dict[str, torch.Tensor],
                              anc: torch.Tensor, pos: int, *, num_heads: int,
                              acc_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Plain PyTorch version (``models/transformer._attend_anc``): each beam
    gathers its lineage's rows from the un-reordered cache and attends
    positions 0..pos with one softmax.  ``acc_dtype`` is the type the sums
    run in."""
    R, _, E = q.shape
    N, K, S = anc.shape
    H, hd = num_heads, E // num_heads
    k, v = kv["k"], kv["v"]
    rows = torch.arange(N, device=anc.device)[:, None, None] * K + anc.long()
    rows = rows[:, :, :pos + 1]                               # (N, K, P)
    s_ids = torch.arange(pos + 1, device=anc.device)
    kg = k[rows, :, s_ids, :].to(acc_dtype)                   # (N, K, P, H, hd)
    vg = v[rows, :, s_ids, :].to(acc_dtype)
    qh = q.reshape(N, K, H, hd).to(acc_dtype)
    s = torch.einsum("nihd,nishd->nihs", qh, kg) * (1.0 / hd ** 0.5)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = torch.einsum("nihs,nishd->nihd", w.to(acc_dtype), vg).to(v.dtype)
    return ctx.reshape(R, 1, E)


def beam_cross_attention_plain(q: torch.Tensor, mem_kv: Dict[str, torch.Tensor],
                               *, mem_group: int, num_heads: int,
                               acc_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Plain PyTorch version (grouped ``models/transformer._attend_hm``): an
    image's K beams as K query rows of one unmasked attention over its
    memory."""
    R, _, E = q.shape
    K, H, hd = mem_group, num_heads, E // num_heads
    qh = q.reshape(R // K, K, H, hd).transpose(1, 2)          # (N, H, K, hd)
    out = attention_core_plain(qh, mem_kv["k"], mem_kv["v"],
                               scale=1.0 / hd ** 0.5, acc_dtype=acc_dtype)
    return out.transpose(1, 2).reshape(R, 1, E)


def _require_cuda(q: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor; got one on {q.device}")


def _check_q(q: torch.Tensor, num_heads: int, dtype: torch.dtype) -> None:
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"q must be (R, 1, E); got {tuple(q.shape)}")
    if dtype not in _DTYPES or q.dtype != dtype:
        raise TypeError(f"q and the cache must share float32 or bfloat16; "
                        f"got {q.dtype} and {dtype}")
    if q.shape[2] != num_heads * HEAD_DIM:
        raise ValueError(f"kernel takes hd={HEAD_DIM}; got E={q.shape[2]} "
                         f"with {num_heads} heads")
    if q.stride(2) != 1 or q.stride(0) % 2 or q.storage_offset() % 2:
        raise ValueError("q rows must be dense, with an even row stride and "
                         "offset")


def _check_cache(name: str, kv: Dict[str, torch.Tensor], q: torch.Tensor,
                 shape) -> None:
    for key in ("k", "v"):
        t = kv[key]
        if t.shape != shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}[{key!r}] must be {tuple(shape)} "
                             f"{q.dtype} on {q.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}[{key!r}] must be contiguous")


def beam_self_attention_cuda(q: torch.Tensor, kv: Dict[str, torch.Tensor],
                             anc: torch.Tensor, pos: int, *, num_heads: int
                             ) -> torch.Tensor:
    """Launch the ancestry self-attention kernel on the current stream."""
    global launches_self
    _require_cuda(q)
    _check_q(q, num_heads, kv["k"].dtype)
    R, _, E = q.shape
    N, K, S = anc.shape
    if R != N * K:
        raise ValueError(f"q has {R} rows, anc {tuple(anc.shape)}")
    _check_cache("kv", kv, q, (R, num_heads, S, HEAD_DIM))
    if anc.dtype != torch.int32 or not anc.is_contiguous() \
            or anc.device != q.device:
        raise ValueError("anc must be a contiguous int32 tensor on q's device")
    pos = int(pos)
    if not 0 <= pos < S or S > MAX_S:
        raise ValueError(f"kernel takes 0 <= pos < S <= {MAX_S}; got "
                         f"pos={pos}, S={S}")
    if kv["k"].data_ptr() % 16 or kv["v"].data_ptr() % 16:
        raise ValueError("kv must be 16-byte aligned: the kernel stages the "
                         "cache rows by 16-byte asynchronous copies")
    out = torch.empty((R, 1, E), dtype=q.dtype, device=q.device)
    lib, fns = _kernels()
    err = _build.call_on(q.device, fns["self"], _DTYPES[q.dtype], q.data_ptr(),
                         q.stride(0), kv["k"].data_ptr(), kv["v"].data_ptr(),
                         anc.data_ptr(), out.data_ptr(), E, R, K, num_heads, S,
                         pos, _SCALE)
    _build.check(lib, err, "beam_self_attention")
    launches_self += 1
    return out


def beam_cross_attention_cuda(q: torch.Tensor, mem_kv: Dict[str, torch.Tensor],
                              *, mem_group: int, num_heads: int
                              ) -> torch.Tensor:
    """Launch the grouped cross-attention kernel on the current stream."""
    global launches_cross
    _require_cuda(q)
    _check_q(q, num_heads, mem_kv["k"].dtype)
    R, _, E = q.shape
    K = int(mem_group)
    if K < 1 or R % K:
        raise ValueError(f"q has {R} rows for groups of {K}")
    N, L = R // K, mem_kv["k"].shape[2]
    _check_cache("mem_kv", mem_kv, q, (N, num_heads, L, HEAD_DIM))
    if not 0 < L <= MAX_L:
        raise ValueError(f"kernel takes 0 < L <= {MAX_L}; got L={L}")
    if mem_kv["k"].data_ptr() % 16 or mem_kv["v"].data_ptr() % 16:
        raise ValueError("mem_kv must be 16-byte aligned: the kernel brings "
                         "each head in by bulk asynchronous copies")
    out = torch.empty((R, 1, E), dtype=q.dtype, device=q.device)
    lib, fns = _kernels()
    err = _build.call_on(q.device, fns["cross"], _DTYPES[q.dtype], q.data_ptr(),
                         q.stride(0), mem_kv["k"].data_ptr(),
                         mem_kv["v"].data_ptr(), out.data_ptr(), E, N, K,
                         num_heads, L, _SCALE)
    _build.check(lib, err, "beam_cross_attention")
    launches_cross += 1
    return out


def beam_self_attention(q: torch.Tensor, kv: Dict[str, torch.Tensor],
                        anc: torch.Tensor, pos: int, *, num_heads: int
                        ) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return beam_self_attention_cuda(q, kv, anc, pos, num_heads=num_heads)
    if q.device.type == "cpu":
        return beam_self_attention_plain(q, kv, anc, pos, num_heads=num_heads)
    raise ValueError(f"beam_self_attention: unsupported device {q.device}")


def beam_cross_attention(q: torch.Tensor, mem_kv: Dict[str, torch.Tensor], *,
                         mem_group: int, num_heads: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return beam_cross_attention_cuda(q, mem_kv, mem_group=mem_group,
                                         num_heads=num_heads)
    if q.device.type == "cpu":
        return beam_cross_attention_plain(q, mem_kv, mem_group=mem_group,
                                          num_heads=num_heads)
    raise ValueError(f"beam_cross_attention: unsupported device {q.device}")
