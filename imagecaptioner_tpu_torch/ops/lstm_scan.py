"""Teacher-forced recurrences of the full and the compact student's decoders
and their reverse-time backwards: the port of
``imagecaptioner_tpu/ops/pallas_lstm.py`` (``pallas_full_decoder_scan``,
``_fused_core_fwd_call``, ``_fused_core_bwd_pallas_call``, ``_get_fused_core``;
for the compact student ``_fused_compact_core_fwd_call``,
``_fused_compact_core_bwd``, ``_get_fused_compact_core``, at the end of this
file).  The full student first.

Operands (E embed, H hidden, L tokens, B batch, T steps; ``dt`` the compute
dtype, float32 or bfloat16):

    emb_w   (T, B, E) dt   emb·W_e + b_comb, computed outside
    f_proj  (B, L, E) dt   feats·W_f + b_attn, computed outside
    feats   (B, L, E) dt
    mask    (T, B, H) f32  inter-layer inverted-dropout multiplier, or None
    w_h (E, H), w_c (E, E), w_ih0 (4H, E), w_hh0, w_ih1, w_hh1 (4H, H)  dt
    b0, b1  (4H,) f32      b_ih + b_hh

The weights are in their torch (out, in) layout, the transpose of the JAX
kernel's operands; ``w_h`` and ``w_c`` may be column slices of the packed
``attention`` / ``attention_combine`` weights (unit stride along a row).

``decoder_scan`` returns ``(h_tops (T,B,H) dt, attn (T,B,L) f32)``.  For a
CPU tensor it runs ``decoder_scan_plain`` under ordinary autograd.  For a
CUDA tensor it launches ``csrc/decoder_scan.cu``; when an input needs a
gradient the launch also writes the residuals h0, c0, c1 and the backward
launches ``csrc/decoder_scan_bwd.cu``.  Nothing falls back: a shape or
layout the kernels do not take raises.  ``decoder_scan_bwd_plain`` is the
step-by-step PyTorch version of the backward (``_fused_core_bwd``), which
the kernel is held against.

The JAX DP form, ``_shard_core_over_batch`` (``pallas_lstm.py:73``), runs
the recurrence per batch shard under ``shard_map``.  Each rank of a
data-parallel world (``core/mesh.py``) holds only its rows and calls these
kernels on them; the weights' gradients are summed by the train step's
all-reduce, so no other code path is needed.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from imagecaptioner_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 2048         # widest E or H the transposed product covers

launches_eval = 0   # forward launches without residuals (the eval form)
launches_train = 0  # forward launches that write the residuals
launches_bwd = 0    # backward launches (reverse-time steps + weight gradients)
launches_compact = 0  # launches of the compact student's forward

# names of the twelve inputs and of the backward's eleven outputs
INPUTS = ("emb_w", "f_proj", "feats", "mask", "w_h", "w_c", "w_ih0", "w_hh0",
          "b0", "w_ih1", "w_hh1", "b1")
GRADS = ("demb_w", "df_proj", "dfeats", "dw_h", "dw_c", "dw_ih0", "dw_hh0",
         "db0", "dw_ih1", "dw_hh1", "db1")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def decoder_scan_plain(emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0,
                       w_ih1, w_hh1, b1, *, residuals: bool = False,
                       acc_dtype: Optional[torch.dtype] = None):
    """Plain version of the forward kernel, differentiable by autograd.
    h and c stay in the accumulation dtype between steps (float32, or
    ``acc_dtype``: float64 shows what the summation order alone is worth);
    every matmul input is rounded to the compute dtype where the kernel
    rounds it.  Returns ``(h_tops, attn)`` or, with ``residuals``, also
    ``(h0s, c0s, c1s)``."""
    T, B, _ = emb_w.shape
    H = w_hh0.shape[1]
    dt = feats.dtype
    acc = acc_dtype or torch.promote_types(torch.float32, dt)

    def rd(x):  # round an accumulator value to the compute dtype
        return x.to(dt).to(acc)

    wt = [w.to(dt).to(acc).t() for w in (w_h, w_c, w_ih0, w_hh0, w_ih1, w_hh1)]
    W_h, W_c, Wih0, Whh0, Wih1, Whh1 = wt
    b0, b1 = b0.to(acc), b1.to(acc)
    fp, ft = f_proj.to(acc), feats.to(acc)

    def cell(x, h, c, w_i, w_hh, b):
        i, f, g, o = (x @ w_i + h @ w_hh + b).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    h0 = c0 = h1 = c1 = torch.zeros(B, H, dtype=acc, device=feats.device)
    h_tops, attns, h0s, c0s, c1s = [], [], [], [], []
    for t in range(T):
        hw = rd(h1) @ W_h
        scores = torch.tanh(fp + hw[:, None, :]).sum(-1)
        w = torch.softmax(scores, dim=-1)
        ctx = (w[:, :, None] * ft).sum(1)
        x0 = rd(emb_w[t].to(acc) + rd(ctx) @ W_c)
        h0, c0 = cell(x0, rd(h0), c0, Wih0, Whh0, b0)
        fed = h0 if mask is None else h0 * mask[t].to(acc)
        h1, c1 = cell(rd(fed), rd(h1), c1, Wih1, Whh1, b1)
        h_tops.append(h1.to(dt))
        attns.append(w)
        if residuals:
            h0s.append(h0.to(dt))
            c0s.append(c0)
            c1s.append(c1)
    out = (torch.stack(h_tops), torch.stack(attns))
    if residuals:
        out += (torch.stack(h0s), torch.stack(c0s), torch.stack(c1s))
    return out


def decoder_scan_bwd_plain(res: Sequence[Optional[torch.Tensor]],
                           dh_tops: Optional[torch.Tensor],
                           dattns: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: the reverse-time loop of
    ``pallas_lstm._fused_core_bwd``, step by step.  ``res`` is the seventeen
    residuals (the twelve inputs, then h_tops, attn, h0s, c0s, c1s).
    Returns the eleven gradients named in ``GRADS`` in the accumulation
    dtype (float32; float64 for float64 residuals), weights in torch (out,
    in) layout."""
    (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1, w_hh1,
     b1, h_tops, attns, h0s, c0s, c1s) = res
    T, B, E = emb_w.shape
    L = feats.shape[1]
    H = w_hh0.shape[1]
    acc = torch.promote_types(torch.float32, emb_w.dtype)
    dev = emb_w.device
    f = lambda x: x.to(acc)  # noqa: E731
    ft, fp = f(feats), f(f_proj)
    W_h, W_c = f(w_h), f(w_c)
    Wih0, Whh0, Wih1, Whh1 = f(w_ih0), f(w_hh0), f(w_ih1), f(w_hh1)
    zeros = lambda *s: torch.zeros(*s, dtype=acc, device=dev)  # noqa: E731

    def gates(x, hp, w_i, w_hh, b):
        g = x @ w_i.t() + hp @ w_hh.t() + f(b)
        i, fg, gg, o = g.chunk(4, dim=-1)
        return (torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(gg),
                torch.sigmoid(o))

    def cell_bwd(dh, dc_carry, c_t, c_prev, i, fg, gg, o):
        tc = torch.tanh(c_t)
        dc = dc_carry + dh * o * (1 - tc * tc)
        dgp = torch.cat([dc * gg * i * (1 - i), dc * c_prev * fg * (1 - fg),
                         dc * i * (1 - gg * gg), dh * tc * o * (1 - o)], -1)
        return dgp, dc * fg

    dh0_c, dc0_c, dh1_c, dc1_c = (zeros(B, H) for _ in range(4))
    demb_w = zeros(T, B, E)
    df_proj, dfeats = zeros(B, L, E), zeros(B, L, E)
    dw_h, dw_c = zeros(E, H), zeros(E, E)
    dw_ih0, dw_hh0 = zeros(4 * H, E), zeros(4 * H, H)
    dw_ih1, dw_hh1 = zeros(4 * H, H), zeros(4 * H, H)
    db0, db1 = zeros(4 * H), zeros(4 * H)
    for t in range(T - 1, -1, -1):
        prev = lambda x: f(x[t - 1]) if t > 0 else zeros(B, H)  # noqa: E731
        h0p, h1p, c0p, c1p = prev(h0s), prev(h_tops), prev(c0s), prev(c1s)
        m_t = 1.0 if mask is None else f(mask[t])
        w_t = f(attns[t])
        h0d = f(h0s[t]) * m_t  # layer 1 saw the dropped h0

        # recompute the forward intermediates of this step
        ctx = (w_t[:, :, None] * ft).sum(1)
        x0 = f(emb_w[t]) + ctx @ W_c.t()
        i0, f0, g0, o0 = gates(x0, h0p, Wih0, Whh0, b0)
        i1, f1, g1, o1 = gates(h0d, h1p, Wih1, Whh1, b1)
        th = torch.tanh(fp + (h1p @ W_h.t())[:, None, :])      # (B, L, E)

        # layer 1, then layer 0
        dh1 = dh1_c + (0.0 if dh_tops is None else f(dh_tops[t]))
        dgp1, dc1_c = cell_bwd(dh1, dc1_c, f(c1s[t]), c1p, i1, f1, g1, o1)
        dh0 = dh0_c + (dgp1 @ Wih1) * m_t
        dh1_rec = dgp1 @ Whh1
        dgp0, dc0_c = cell_bwd(dh0, dc0_c, f(c0s[t]), c0p, i0, f0, g0, o0)
        dx0 = dgp0 @ Wih0
        dh0_c = dgp0 @ Whh0

        # combine and attention
        dctx = dx0 @ W_c
        dw = torch.einsum("be,ble->bl", dctx, ft)
        if dattns is not None:
            dw = dw + f(dattns[t])
        ds = w_t * (dw - (w_t * dw).sum(-1, keepdim=True))
        dth = ds[:, :, None] * (1 - th * th)                   # (B, L, E)
        dhw = dth.sum(1)
        dh1_c = dh1_rec + dhw @ W_h

        demb_w[t] = dx0
        df_proj += dth
        dfeats += w_t[:, :, None] * dctx[:, None, :]
        dw_h += dhw.t() @ h1p
        dw_c += dx0.t() @ ctx
        dw_ih0 += dgp0.t() @ x0
        dw_hh0 += dgp0.t() @ h0p
        db0 += dgp0.sum(0)
        dw_ih1 += dgp1.t() @ h0d
        dw_hh1 += dgp1.t() @ h1p
        db1 += dgp1.sum(0)
    return (demb_w, df_proj, dfeats, dw_h, dw_c, dw_ih0, dw_hh0, db0, dw_ih1,
            dw_hh1, db1)


def decoder_scan_bwd_staged(res: Sequence[Optional[torch.Tensor]],
                            dh_tops: Optional[torch.Tensor],
                            dattns: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's decomposition in plain PyTorch (a test helper:
    nothing on the card calls it).  1. Recompute every step's forward
    intermediates for all T·B rows at once, and G = feats·W_cᵀ.  2. The
    reverse chain in the kernel's five phases per step: dh1 (from the last
    step's dhw) and layer 1's cell; d(h0·mask), dh1_rec and layer 0's cell;
    dx0 and the carried dh0; dctx and d(weights) = dx0·Gᵀ + dattn; d(scores)
    and dhw.  3. dfeats and df_proj after the loop from the per-step stores.
    4. The weight gradients as products over all rows.  Same contract as
    ``decoder_scan_bwd_plain``."""
    (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1, w_hh1,
     b1, h_tops, attns, h0s, c0s, c1s) = res
    T, B, E = emb_w.shape
    H = w_hh0.shape[1]
    acc = torch.promote_types(torch.float32, emb_w.dtype)
    f = lambda x: x.to(acc)  # noqa: E731
    W_h, W_c = f(w_h), f(w_c)
    Wih0, Whh0, Wih1, Whh1 = f(w_ih0), f(w_hh0), f(w_ih1), f(w_hh1)
    ft, fp, w = f(feats), f(f_proj), f(attns)

    # 1. recompute, all rows
    zero = torch.zeros(1, B, H, dtype=acc, device=emb_w.device)
    h0p = torch.cat([zero, f(h0s[:-1])])
    h1p = torch.cat([zero, f(h_tops[:-1])])
    h0d = f(h0s) * (1.0 if mask is None else f(mask))
    ctx = torch.einsum("tbl,ble->tbe", w, ft)
    hw = h1p @ W_h.t()
    x0 = f(emb_w) + ctx @ W_c.t()

    def act(g):
        i, fg, gg, o = g.chunk(4, dim=-1)
        return torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(gg), torch.sigmoid(o)

    act0 = act(x0 @ Wih0.t() + h0p @ Whh0.t() + f(b0))
    act1 = act(h0d @ Wih1.t() + h1p @ Whh1.t() + f(b1))
    G = ft @ W_c.t()                                     # (B, L, E)

    def cell_bwd(dh, dc, c_t, c_prev, i, fg, gg, o):
        tc = torch.tanh(c_t)
        dcn = dc + dh * o * (1 - tc * tc)
        dgp = torch.cat([dcn * gg * i * (1 - i), dcn * c_prev * fg * (1 - fg),
                         dcn * i * (1 - gg * gg), dh * tc * o * (1 - o)], -1)
        return dgp, dcn * fg

    # 2. the reverse chain
    zeros = lambda *s: torch.zeros(*s, dtype=acc, device=emb_w.device)  # noqa: E731
    dc0, dc1, dh0c, dh1rec = (zeros(B, H) for _ in range(4))
    dgp0s, dgp1s, dx0s, dctxs, dss, dhws = ([None] * T for _ in range(6))
    for t in range(T - 1, -1, -1):
        dh1 = zeros(B, H) if t == T - 1 else dh1rec + dhws[t + 1] @ W_h
        if dh_tops is not None:
            dh1 = dh1 + f(dh_tops[t])
        c1p = f(c1s[t - 1]) if t > 0 else zeros(B, H)
        c0p = f(c0s[t - 1]) if t > 0 else zeros(B, H)
        dgp1, dc1 = cell_bwd(dh1, dc1, f(c1s[t]), c1p,
                             *(a[t] for a in act1))
        dh1rec = dgp1 @ Whh1
        m_t = 1.0 if mask is None else f(mask[t])
        dh0 = dh0c + (dgp1 @ Wih1) * m_t
        dgp0, dc0 = cell_bwd(dh0, dc0, f(c0s[t]), c0p, *(a[t] for a in act0))
        dx0 = dgp0 @ Wih0
        dh0c = dgp0 @ Whh0
        dctxs[t] = dx0 @ W_c
        dw = torch.einsum("be,ble->bl", dx0, G)
        if dattns is not None:
            dw = dw + f(dattns[t])
        ds = w[t] * (dw - (w[t] * dw).sum(-1, keepdim=True))
        th = torch.tanh(fp + hw[t][:, None, :])
        dhws[t] = (ds[:, :, None] * (1 - th * th)).sum(1)
        dgp0s[t], dgp1s[t], dx0s[t], dss[t] = dgp0, dgp1, dx0, ds
    dgp0, dgp1, dx0, dctx, ds, dhw = (torch.stack(x) for x in
                                      (dgp0s, dgp1s, dx0s, dctxs, dss, dhws))

    # 3. after the loop
    dfeats = torch.einsum("tbl,tbe->ble", w, dctx)
    th = torch.tanh(fp[None] + hw[:, :, None, :])        # (T, B, L, E)
    df_proj = (ds[..., None] * (1 - th * th)).sum(0)

    # 4. weight gradients over all T·B rows
    flat = lambda x: x.reshape(T * B, -1)  # noqa: E731
    prod = lambda d, x: flat(d).t() @ flat(x)  # noqa: E731
    return (dx0, df_proj, dfeats, prod(dhw, h1p), prod(dx0, ctx),
            prod(dgp0, x0), prod(dgp0, h0p), flat(dgp0).sum(0),
            prod(dgp1, h0d), prod(dgp1, h1p), flat(dgp1).sum(0))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


def _check_operands(emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0,
                    w_ih1, w_hh1, b1) -> Tuple[int, int, int, int, int]:
    """Raise on anything the kernels do not take; returns (T, B, L, E, H)."""
    if not feats.is_cuda or feats.dim() != 3 or emb_w.dim() != 3:
        raise ValueError("decoder scan kernel: feats (B, L, E) and emb_w "
                         "(T, B, E) must be CUDA tensors")
    dt = feats.dtype
    if dt not in _DTYPES:
        raise TypeError(f"decoder scan kernel: dtype {dt} not supported")
    T, B, E = emb_w.shape
    L = feats.shape[1]
    H = w_hh0.shape[1]
    if E % 8 or H % 8 or max(E, H) > MAX_WIDTH or T < 1:
        raise ValueError(f"decoder scan kernel needs E and H divisible by 8 "
                         f"and at most {MAX_WIDTH}, got E={E}, H={H}, T={T}")
    want = {"emb_w": ((T, B, E), dt), "f_proj": ((B, L, E), dt),
            "feats": ((B, L, E), dt), "w_h": ((E, H), dt), "w_c": ((E, E), dt),
            "w_ih0": ((4 * H, E), dt), "w_hh0": ((4 * H, H), dt),
            "b0": ((4 * H,), torch.float32), "w_ih1": ((4 * H, H), dt),
            "w_hh1": ((4 * H, H), dt), "b1": ((4 * H,), torch.float32)}
    if mask is not None:
        want["mask"] = ((T, B, H), torch.float32)
    given = dict(zip(INPUTS, (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0,
                              w_hh0, b0, w_ih1, w_hh1, b1)))
    for name, (shape, dtype) in want.items():
        t = given[name]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != feats.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {shape} {dtype} on "
                             f"{feats.device}")
        if name in ("w_h", "w_c"):  # may be a column slice of a packed weight
            ok = t.stride(1) == 1 and (t.stride(0) * t.element_size()) % 16 == 0
        else:
            ok = t.is_contiguous()
        if not ok or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous (w_h, w_c: unit "
                             "stride along a row) and 16-byte aligned")
    return T, B, L, E, H


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


_FWD = None  # (library, its entry points with argtypes set), at first use
HIDDEN_PER_BLOCK, E_PER_BLOCK = 4, 2  # csrc/decoder_scan.cu caps


def _fwd_library():
    global _FWD
    if _FWD is None:
        lib = _build.library("decoder_scan")
        fns = {"blocks": lib.ic_decoder_scan_blocks,
               "workspace": lib.ic_decoder_scan_workspace_bytes,
               "scan": lib.ic_decoder_scan}
        fns["blocks"].restype = fns["scan"].restype = ctypes.c_int
        fns["workspace"].restype = ctypes.c_longlong
        fns["blocks"].argtypes = [ctypes.c_int] * 4 + \
            [ctypes.POINTER(ctypes.c_longlong)]
        fns["workspace"].argtypes = [ctypes.c_int] * 3
        fns["scan"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        _FWD = lib, fns
    return _FWD


def decoder_scan_blocks(dt, dev, L: int, E: int, H: int) -> int:
    """The forward kernel's cooperative grid on this card (one block an
    SM); raises if the kernel does not fit or its blocks would own more
    columns than it takes."""
    _, fns = _fwd_library()
    return _build.cooperative_grid(
        ("decoder_scan", dt, dev, L, E, H),
        lambda smem: fns["blocks"](_DTYPES[dt], L, E, H, smem),
        "decoder scan kernel", (("H", H, HIDDEN_PER_BLOCK),
                                ("E", E, E_PER_BLOCK)))


def decoder_scan_cuda(emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0,
                      w_ih1, w_hh1, b1, *, residuals: bool = False):
    """Launch the cooperative forward kernel on the current stream.  Returns
    ``(h_tops, attn)`` or, with ``residuals``, also ``(h0s, c0s, c1s)``."""
    global launches_eval, launches_train
    ops = (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1,
           w_hh1, b1)
    T, B, L, E, H = _check_operands(*ops)
    if E % 16 or H % 16:
        raise ValueError(f"decoder scan kernel needs E and H divisible by 16, "
                         f"got E={E}, H={H}")
    dt, dev = feats.dtype, feats.device
    lib, fns = _fwd_library()
    blocks = decoder_scan_blocks(dt, dev, L, E, H)
    ws = torch.zeros(fns["workspace"](_DTYPES[dt], E, H), dtype=torch.uint8,
                     device=dev)
    h_tops = torch.empty((T, B, H), dtype=dt, device=dev)
    attn = torch.empty((T, B, L), dtype=torch.float32, device=dev)
    res = (None, None, None)
    if residuals:
        res = (torch.empty((T, B, H), dtype=dt, device=dev),
               torch.empty((T, B, H), dtype=torch.float32, device=dev),
               torch.empty((T, B, H), dtype=torch.float32, device=dev))
    err = _build.call_on(dev, fns["scan"], _DTYPES[dt],
                         _ptr_array(ops + (h_tops, attn) + res), ws.data_ptr(),
                         blocks, T, B, L, E, H, w_h.stride(0), w_c.stride(0))
    _build.check(lib, err, "decoder_scan")
    if residuals:
        launches_train += 1
        return (h_tops, attn) + res
    launches_eval += 1
    return h_tops, attn


CHAIN_MAX_COLUMNS = 4  # columns of H or E one block of the chain may own
# per-step float32 stores of the backward, in the order the kernel takes them
BWD_STORES = ("h0p", "h1p", "h0d", "ctx", "hw", "x0", "act0", "act1", "featsf",
              "G", "dgp0", "dgp1", "dx0", "dctx", "dw", "ds", "dhw")


def decoder_scan_bwd_buffers(res, dh_tops, dattns) -> dict:
    """Check the residuals and cotangents and allocate what the backward's
    stages write: the per-step stores (``BWD_STORES``), the zeroed carries
    and barrier words of the chain, and df_proj, dfeats.  Returns a dict
    that ``decoder_scan_bwd_stage_cuda`` and ``decoder_scan_bwd_weights_cuda``
    take."""
    T, B, L, E, H = _check_operands(*res[:12])
    dt, dev = res[2].dtype, res[2].device
    traj = {"h_tops": ((T, B, H), dt), "attn": ((T, B, L), torch.float32),
            "h0s": ((T, B, H), dt), "c0s": ((T, B, H), torch.float32),
            "c1s": ((T, B, H), torch.float32),
            "dh_tops": ((T, B, H), dt), "dattns": ((T, B, L), torch.float32)}
    for (name, (shape, dtype)), t in zip(traj.items(),
                                         tuple(res[12:]) + (dh_tops, dattns)):
        if t is None and name in ("dh_tops", "dattns"):
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} "
                             f"on {dev}")
    blocks = chain_blocks(dt, dev, B, L, E, H)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    shapes = {"h0p": (T, B, H), "h1p": (T, B, H), "h0d": (T, B, H),
              "ctx": (T, B, E), "hw": (T, B, E), "x0": (T, B, E),
              "act0": (T, B, 4 * H), "act1": (T, B, 4 * H),
              "featsf": (B, L, E), "G": (B, L, E), "dgp0": (T, B, 4 * H),
              "dgp1": (T, B, 4 * H), "dx0": (T, B, E), "dctx": (T, B, E),
              "dw": (T, B, L), "ds": (T, B, L), "dhw": (T, B, E)}
    buf = {k: new(*shapes[k]) for k in BWD_STORES}
    # four (B, H) carries and the barrier's two words, zeroed in one fill
    zeroed = torch.zeros(4 * B * H + 4, dtype=torch.float32, device=dev)
    carries = zeroed[:4 * B * H].view(4, B, H)
    buf.update(df_proj=new(B, L, E), dfeats=new(B, L, E), zeroed=zeroed,
               dims=(T, B, L, E, H), dtype=dt, device=dev)
    ptrs = (tuple(res) + (dh_tops, dattns) + tuple(buf[k] for k in BWD_STORES)
            + tuple(carries) + (zeroed[4 * B * H:], buf["df_proj"],
                                buf["dfeats"]))
    buf["ptrs"] = _ptr_array(ptrs)
    buf["keep"] = ptrs  # the tensors the pointer array points at
    buf["ld"] = (res[4].stride(0), res[5].stride(0))
    buf["blocks"] = blocks
    return buf


def decoder_scan_bwd_stage_cuda(buf: dict, stage: int) -> None:
    """Launch one stage of the backward on the current stream: 0 the
    recompute of every step's forward intermediates, 1 the reverse chain
    (one cooperative kernel), 2 the post-loop reductions (df_proj, dfeats).
    The chain zeroes nothing itself: run it once per
    ``decoder_scan_bwd_buffers``."""
    lib, fns = _bwd_library()
    err = _build.call_on(buf["device"], fns["stage"], stage,
                         _DTYPES[buf["dtype"]], buf["ptrs"], *buf["dims"],
                         *buf["ld"], buf["blocks"])
    _build.check(lib, err, f"decoder_scan_bwd (stage {stage})")


def decoder_scan_bwd_weights_cuda(buf: dict):
    """The weight- and bias-gradient kernels alone: sums over the T·B rows
    of the per-step stores.  Returns dw_h, dw_c, dw_ih0, dw_hh0, db0,
    dw_ih1, dw_hh1, db1 (float32, torch layout)."""
    T, B, L, E, H = buf["dims"]
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=buf["device"])  # noqa: E731
    outs = (new(E, H), new(E, E), new(4 * H, E), new(4 * H, H), new(4 * H),
            new(4 * H, H), new(4 * H, H), new(4 * H))
    stores = tuple(buf[k] for k in ("dgp0", "dgp1", "dhw", "dx0", "x0", "ctx",
                                    "h0p", "h1p", "h0d"))
    lib, fns = _bwd_library()
    err = _build.call_on(buf["device"], fns["weights"], _ptr_array(stores),
                         _ptr_array(outs), T * B, E, H)
    _build.check(lib, err, "decoder_scan_bwd (weights)")
    return outs


_BWD = None  # (library, its entry points with argtypes set), at first use
def chain_blocks(dt, dev, B, L, E, H) -> int:
    """The reverse chain's cooperative grid on this card (as many blocks as
    it holds at once); raises if the kernel does not fit or its blocks
    would own more columns than it takes."""
    _, fns = _bwd_library()
    return _build.cooperative_grid(
        ("decoder_scan_bwd", dt, dev, B, L, E, H),
        lambda smem: fns["blocks"](_DTYPES[dt], B, L, E, H, smem),
        "decoder_scan_bwd: the chain kernel",
        (("H", H, CHAIN_MAX_COLUMNS), ("E", E, CHAIN_MAX_COLUMNS)))


def _bwd_library():
    global _BWD
    if _BWD is None:
        lib = _build.library("decoder_scan_bwd")
        fns = {"blocks": lib.ic_decoder_scan_bwd_chain_blocks,
               "stage": lib.ic_decoder_scan_bwd_stage,
               "weights": lib.ic_decoder_scan_bwd_weights}
        for f in fns.values():
            f.restype = ctypes.c_int
        fns["blocks"].argtypes = [ctypes.c_int] * 5 + \
            [ctypes.POINTER(ctypes.c_longlong)]
        fns["stage"].argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fns["weights"].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        _BWD = lib, fns
    return _BWD


def decoder_scan_bwd_cuda(res, dh_tops, dattns) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels on the current stream.  Same contract as
    ``decoder_scan_bwd_plain``; the gradients are float32."""
    global launches_bwd
    buf = decoder_scan_bwd_buffers(res, dh_tops, dattns)
    for stage in (0, 1, 2):
        decoder_scan_bwd_stage_cuda(buf, stage)
    dw_h, dw_c, dw_ih0, dw_hh0, db0, dw_ih1, dw_hh1, db1 = \
        decoder_scan_bwd_weights_cuda(buf)
    launches_bwd += 1
    return (buf["dx0"], buf["df_proj"], buf["dfeats"], dw_h, dw_c, dw_ih0,
            dw_hh0, db0, dw_ih1, dw_hh1, db1)


class _DecoderScan(torch.autograd.Function):
    """The kernel pair under autograd (``pallas_lstm._get_fused_core``)."""

    @staticmethod
    def forward(ctx, *ops):
        need = any(ctx.needs_input_grad)
        out = decoder_scan_cuda(*ops, residuals=need)
        if need:
            ctx.mask = ops[3]  # a constant: no gradient, not a saved tensor
            ctx.save_for_backward(*ops[:3], *ops[4:], *out)
        ctx.set_materialize_grads(False)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dh_tops, dattns):
        saved = ctx.saved_tensors
        res = saved[:3] + (ctx.mask,) + saved[3:]
        if dh_tops is None and dattns is None:
            return (None,) * 12
        dh_tops = None if dh_tops is None else dh_tops.contiguous()
        dattns = None if dattns is None else dattns.contiguous()
        g = decoder_scan_bwd_cuda(res, dh_tops, dattns)
        grads = iter(g)
        out = []
        for i, op in enumerate(res[:12]):
            if i == 3:  # mask
                out.append(None)
                continue
            gi = next(grads)
            out.append(gi.to(op.dtype) if ctx.needs_input_grad[i] else None)
        return tuple(out)


def decoder_scan(emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1,
                 w_hh1, b1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels for CUDA tensors, the plain version for CPU tensors."""
    ops = (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1,
           w_hh1, b1)
    if feats.is_cuda:
        return _DecoderScan.apply(*ops)
    if feats.device.type == "cpu":
        return decoder_scan_plain(*ops)
    raise ValueError(f"decoder_scan: unsupported device {feats.device}")


# ---------------------------------------------------------------------------
# The compact student's recurrence (1-layer LSTM, dot attention, additive
# fusion, no dropout).  Operands:
#
#     emb     (T, B, E) dt   word embeddings
#     feats   (B, L, E) dt
#     w_attn  (E, H) dt, b_attn (E,) f32
#     w_ih (4H, E), w_hh (4H, H) dt, b (4H,) f32 = b_ih + b_hh
#
# ``compact_decoder_scan`` returns ``(h (T,B,H) dt, attn (T,B,L) f32)``; the
# kernel always writes the cell trajectory c (T,B,H) f32 too, the residual of
# the backward.  The JAX package has no backward kernel here (its custom VJP
# is an XLA reverse scan), so the backward is plain PyTorch on either device.
# ---------------------------------------------------------------------------

COMPACT_INPUTS = ("emb", "feats", "w_attn", "b_attn", "w_ih", "w_hh", "b")


def compact_scan_plain(emb, feats, w_attn, b_attn, w_ih, w_hh, b, *,
                       acc_dtype: Optional[torch.dtype] = None):
    """Plain version of the compact forward kernel, differentiable by
    autograd.  Returns ``(hs, attn, cs)``."""
    T, B, _ = emb.shape
    H = w_hh.shape[1]
    dt = feats.dtype
    acc = acc_dtype or torch.promote_types(torch.float32, dt)

    def rd(x):
        return x.to(dt).to(acc)

    Wa, Wih, Whh = (w.to(dt).to(acc).t() for w in (w_attn, w_ih, w_hh))
    ba, bl = b_attn.to(acc), b.to(acc)
    ft = feats.to(acc)
    h = c = torch.zeros(B, H, dtype=acc, device=feats.device)
    hs, attns, cs = [], [], []
    for t in range(T):
        hp = rd(h) @ Wa + ba
        w = torch.softmax((hp[:, None, :] * ft).sum(-1), dim=-1)
        ctx = (w[:, :, None] * ft).sum(1)
        x0 = rd(emb[t].to(acc) + ctx)
        i, f, g, o = (x0 @ Wih + rd(h) @ Whh + bl).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h.to(dt))
        attns.append(w)
        cs.append(c)
    return torch.stack(hs), torch.stack(attns), torch.stack(cs)


def compact_scan_bwd_plain(res: Sequence[torch.Tensor],
                           dhs: Optional[torch.Tensor],
                           dattns: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, ...]:
    """The reverse-time loop of ``pallas_lstm._fused_compact_core_bwd`` over
    the residuals ``res`` (the seven inputs, then hs, attn, cs).  Returns
    the gradients of the seven inputs in the accumulation dtype, weights in
    torch (out, in) layout."""
    emb, feats, w_attn, b_attn, w_ih, w_hh, b, hs, attns, cs = res
    T, B, E = emb.shape
    H = w_hh.shape[1]
    acc = torch.promote_types(torch.float32, emb.dtype)
    f = lambda x: x.to(acc)  # noqa: E731
    ft, Wa, Wih, Whh = f(feats), f(w_attn), f(w_ih), f(w_hh)
    zeros = lambda *s: torch.zeros(*s, dtype=acc, device=emb.device)  # noqa: E731
    dh_c, dc_c = zeros(B, H), zeros(B, H)
    dfeats = torch.zeros_like(ft)
    keep = {k: [] for k in ("dx0", "dhp", "dg", "x0", "hp")}
    for t in range(T - 1, -1, -1):
        hp_t = f(hs[t - 1]) if t > 0 else zeros(B, H)
        cp_t = f(cs[t - 1]) if t > 0 else zeros(B, H)
        w_t, c_t = f(attns[t]), f(cs[t])
        # recompute the forward intermediates of this step
        ctx = torch.einsum("bl,ble->be", w_t, ft)
        x0 = f(emb[t]) + ctx
        g = x0 @ Wih.t() + hp_t @ Whh.t() + f(b)
        i, fg, gg, o = g.chunk(4, dim=-1)
        i, fg, gg, o = (torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(gg),
                        torch.sigmoid(o))
        hproj = hp_t @ Wa.t() + f(b_attn)
        # the cell
        dh = dh_c if dhs is None else dh_c + f(dhs[t])
        tc = torch.tanh(c_t)
        dc = dc_c + dh * o * (1 - tc * tc)
        dg = torch.cat([dc * gg * i * (1 - i), dc * cp_t * fg * (1 - fg),
                        dc * i * (1 - gg * gg), dh * tc * o * (1 - o)], -1)
        dx0 = dg @ Wih
        dc_c = dc * fg
        # additive fusion and dot attention
        dw = torch.einsum("be,ble->bl", dx0, ft)
        if dattns is not None:
            dw = dw + f(dattns[t])
        ds = w_t * (dw - (w_t * dw).sum(-1, keepdim=True))
        dhp = torch.einsum("bl,ble->be", ds, ft)
        dh_c = dg @ Whh + dhp @ Wa
        dfeats += w_t[:, :, None] * dx0[:, None, :] \
            + ds[:, :, None] * hproj[:, None, :]
        for k, v in (("dx0", dx0), ("dhp", dhp), ("dg", dg), ("x0", x0),
                     ("hp", hp_t)):
            keep[k].append(v)
    # the weight gradients are sums over all (t, b) rows: one product each
    s = {k: torch.stack(v[::-1]) for k, v in keep.items()}
    flat = lambda x: x.reshape(T * B, -1)  # noqa: E731
    return (s["dx0"], dfeats, flat(s["dhp"]).t() @ flat(s["hp"]),
            flat(s["dhp"]).sum(0), flat(s["dg"]).t() @ flat(s["x0"]),
            flat(s["dg"]).t() @ flat(s["hp"]), flat(s["dg"]).sum(0))


COMPACT_HIDDEN_PER_BLOCK, COMPACT_E_PER_BLOCK = 4, 2
COMPACT_CHUNK = 16  # batch rows a chunk, each attended by a block of its own
# (csrc/compact_scan.cu caps)

_COMPACT = None  # (library, its entry points with argtypes set), at first use


def _compact_library():
    global _COMPACT
    if _COMPACT is None:
        lib = _build.library("compact_scan")
        fns = {"blocks": lib.ic_compact_scan_blocks,
               "workspace": lib.ic_compact_scan_workspace_bytes,
               "scan": lib.ic_compact_scan}
        i, p = ctypes.c_int, ctypes.c_void_p
        fns["blocks"].argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        fns["workspace"].argtypes = [i] * 3
        fns["scan"].argtypes = [i, p, p] + [i] * 6 + [p]
        fns["blocks"].restype = fns["scan"].restype = i
        fns["workspace"].restype = ctypes.c_longlong
        _COMPACT = lib, fns
    return _COMPACT


def _require_cuda(feats: torch.Tensor) -> None:
    if not feats.is_cuda:
        raise ValueError(f"compact scan kernel: the operands must be CUDA "
                         f"tensors; got feats on {feats.device}")


def compact_scan_blocks(dt, dev, L: int, E: int, H: int) -> int:
    """The compact scan's cooperative grid on this card (one block an SM);
    raises if the kernel does not fit, if its blocks would own more columns
    than it takes, or if there are fewer blocks than the rows of a
    chunk."""
    _, fns = _compact_library()
    n = _build.cooperative_grid(
        ("compact_scan", dt, dev, L, E, H),
        lambda smem: fns["blocks"](_DTYPES[dt], L, E, H, smem),
        "compact scan kernel", (("H", H, COMPACT_HIDDEN_PER_BLOCK),
                                ("E", E, COMPACT_E_PER_BLOCK)))
    if n < COMPACT_CHUNK:
        raise ValueError(f"compact scan kernel: {n} cooperative blocks, "
                         f"fewer than the {COMPACT_CHUNK} rows of a chunk "
                         f"that each take a block")
    return n


def compact_scan_cuda(emb, feats, w_attn, b_attn, w_ih, w_hh, b):
    """Launch the cooperative ``csrc/compact_scan.cu`` on the current stream
    (any B: rows beyond 16 run as further chunks inside the launch).
    Returns ``(hs, attn, cs)``."""
    global launches_compact
    _require_cuda(feats)
    if feats.dim() != 3 or emb.dim() != 3:
        raise ValueError("compact scan kernel: feats must be (B, L, E) and "
                         "emb (T, B, E)")
    dt, dev = feats.dtype, feats.device
    if dt not in _DTYPES:
        raise TypeError(f"compact scan kernel: dtype {dt} not supported")
    T, B, E = emb.shape
    L, H = feats.shape[1], w_hh.shape[1]
    if E % 16 or H % 16 or T < 1:
        raise ValueError(f"compact scan kernel needs E and H divisible by 16, "
                         f"got E={E}, H={H}, T={T}")
    want = {"emb": ((T, B, E), dt), "feats": ((B, L, E), dt),
            "w_attn": ((E, H), dt), "b_attn": ((E,), torch.float32),
            "w_ih": ((4 * H, E), dt), "w_hh": ((4 * H, H), dt),
            "b": ((4 * H,), torch.float32)}
    ops = (emb, feats, w_attn, b_attn, w_ih, w_hh, b)
    for (name, (shape, dtype)), t in zip(want.items(), ops):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected contiguous, 16-byte "
                             f"aligned {shape} {dtype} on {dev}")
    lib, fns = _compact_library()
    blocks = compact_scan_blocks(dt, dev, L, E, H)
    ws = _build.workspace(("compact_scan", dt, dev, E, H, _build.stream_of(dev)),
                          lambda: fns["workspace"](_DTYPES[dt], E, H), dev)
    hs = torch.empty((T, B, H), dtype=dt, device=dev)
    attn = torch.empty((T, B, L), dtype=torch.float32, device=dev)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    err = _build.call_on(dev, fns["scan"], _DTYPES[dt],
                         _ptr_array(ops + (hs, attn, cs)), ws.data_ptr(),
                         blocks, T, B, L, E, H)
    _build.check(lib, err, "compact_scan")
    launches_compact += 1
    return hs, attn, cs


class _CompactScan(torch.autograd.Function):
    """The forward kernel under autograd with the plain reverse-time
    backward (``pallas_lstm._get_fused_compact_core``)."""

    @staticmethod
    def forward(ctx, *ops):
        hs, attn, cs = compact_scan_cuda(*ops)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*ops, hs, attn, cs)
        ctx.set_materialize_grads(False)
        return hs, attn

    @staticmethod
    def backward(ctx, dhs, dattns):
        if dhs is None and dattns is None:
            return (None,) * 7
        res = ctx.saved_tensors
        grads = compact_scan_bwd_plain(res, dhs, dattns)
        return tuple(g.to(op.dtype) if need else None for g, op, need in
                     zip(grads, res, ctx.needs_input_grad))


def compact_decoder_scan(emb, feats, w_attn, b_attn, w_ih, w_hh, b
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    ops = (emb, feats, w_attn, b_attn, w_ih, w_hh, b)
    if feats.is_cuda:
        return _CompactScan.apply(*ops)
    if feats.device.type == "cpu":
        return compact_scan_plain(*ops)[:2]
    raise ValueError(f"compact_decoder_scan: unsupported device {feats.device}")
