"""Teacher-forced recurrence of the full student's decoder and its
reverse-time backward: the port of the full-student half of
``imagecaptioner_tpu/ops/pallas_lstm.py`` (``pallas_full_decoder_scan``,
``_fused_core_fwd_call``, ``_fused_core_bwd_pallas_call``, ``_get_fused_core``).

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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from imagecaptioner_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448  # per block on the H100
MAX_WIDTH = 2048         # widest E or H the transposed product covers

launches_eval = 0   # forward launches without residuals (the eval form)
launches_train = 0  # forward launches that write the residuals
launches_bwd = 0    # backward launches (reverse-time steps + weight gradients)

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


def _smem_ok(lib, fn_name: str, L: int, E: int, H: int) -> None:
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    smem = fn(L, E, H)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decoder scan kernel: {smem} bytes of shared memory "
                         f"for L={L}, E={E}, H={H} exceed {MAX_SMEM_BYTES}")


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


def decoder_scan_cuda(emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0,
                      w_ih1, w_hh1, b1, *, residuals: bool = False):
    """Launch the forward kernel on the current stream.  Returns ``(h_tops,
    attn)`` or, with ``residuals``, also ``(h0s, c0s, c1s)``."""
    global launches_eval, launches_train
    ops = (emb_w, f_proj, feats, mask, w_h, w_c, w_ih0, w_hh0, b0, w_ih1,
           w_hh1, b1)
    T, B, L, E, H = _check_operands(*ops)
    dt, dev = feats.dtype, feats.device
    lib = _build.library("decoder_scan")
    _smem_ok(lib, "ic_decoder_scan_smem_bytes", L, E, H)
    h_tops = torch.empty((T, B, H), dtype=dt, device=dev)
    attn = torch.empty((T, B, L), dtype=torch.float32, device=dev)
    res = (None, None, None)
    if residuals:
        res = (torch.empty((T, B, H), dtype=dt, device=dev),
               torch.empty((T, B, H), dtype=torch.float32, device=dev),
               torch.empty((T, B, H), dtype=torch.float32, device=dev))
    fn = lib.ic_decoder_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dt], _ptr_array(ops + (h_tops, attn) + res), T, B, L,
                 E, H, w_h.stride(0), w_c.stride(0), stream)
    _build.check(lib, err, "decoder_scan")
    if residuals:
        launches_train += 1
        return (h_tops, attn) + res
    launches_eval += 1
    return h_tops, attn


def decoder_scan_bwd_steps_cuda(res, dh_tops, dattns):
    """The reverse-time kernel alone.  Returns ``(df_proj, dfeats, stores)``
    where ``stores`` are the nine per-step float32 arrays the weight
    gradients are summed from: dgp0, dgp1, dhw, dx0, x0, ctx, h0p, h1p, h0d
    (``dx0`` is also ``demb_w``)."""
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
    lib = _build.library("decoder_scan_bwd")
    _smem_ok(lib, "ic_decoder_scan_bwd_smem_bytes", L, E, H)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    df_proj, dfeats = new(B, L, E), new(B, L, E)
    stores = (new(T, B, 4 * H), new(T, B, 4 * H), new(T, B, E), new(T, B, E),
              new(T, B, E), new(T, B, E), new(T, B, H), new(T, B, H),
              new(T, B, H))
    fn = lib.ic_decoder_scan_bwd_steps
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    ptrs = _ptr_array(tuple(res) + (dh_tops, dattns, df_proj, dfeats) + stores)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dt], ptrs, T, B, L, E, H, res[4].stride(0),
                 res[5].stride(0), stream)
    _build.check(lib, err, "decoder_scan_bwd (steps)")
    return df_proj, dfeats, stores


def decoder_scan_bwd_weights_cuda(stores, E: int, H: int):
    """The weight- and bias-gradient kernels alone: sums over the T·B rows
    of the per-step stores.  Returns dw_h, dw_c, dw_ih0, dw_hh0, db0,
    dw_ih1, dw_hh1, db1 (float32, torch layout)."""
    dev = stores[0].device
    N = stores[0].shape[0] * stores[0].shape[1]
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (new(E, H), new(E, E), new(4 * H, E), new(4 * H, H), new(4 * H),
            new(4 * H, H), new(4 * H, H), new(4 * H))
    lib = _build.library("decoder_scan_bwd")
    fn = lib.ic_decoder_scan_bwd_weights
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr_array(stores), _ptr_array(outs), N, E, H, stream)
    _build.check(lib, err, "decoder_scan_bwd (weights)")
    return outs


def decoder_scan_bwd_cuda(res, dh_tops, dattns) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels on the current stream.  Same contract as
    ``decoder_scan_bwd_plain``; the gradients are float32."""
    global launches_bwd
    df_proj, dfeats, stores = decoder_scan_bwd_steps_cuda(res, dh_tops, dattns)
    E, H = res[0].shape[2], res[7].shape[1]
    dw_h, dw_c, dw_ih0, dw_hh0, db0, dw_ih1, dw_hh1, db1 = \
        decoder_scan_bwd_weights_cuda(stores, E, H)
    launches_bwd += 1
    return (stores[3], df_proj, dfeats, dw_h, dw_c, dw_ih0, dw_hh0, db0,
            dw_ih1, dw_hh1, db1)


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
