"""Teacher-forced recurrence of the enhanced student's decoder: the port of
``imagecaptioner_tpu/ops/pallas_enhanced.py`` (``_fused_enhanced_core_fwd_call``,
``_fused_enhanced_core_bwd``, ``_get_fused_enhanced_core``).

Operands (E embed, H hidden, L tokens, nh heads of hd = E / nh, B batch, T
steps; ``dt`` the compute dtype, float32 or bfloat16):

    embp    (T, B, E) dt    word embeddings + learned positions
    gate_w  (T, B, E) f32   embp·W_gate[:, :E]ᵀ + b_gate, computed outside
    k, v    (B, nh, L, hd) dt   projected image features, split into heads
    amask   (T, B, nh, L) f32   attention-weight dropout multiplier, or None
    lmask   (3, T, B, H) f32    per-layer output dropout multiplier, or None
    weights: the 23 tensors named in ``WEIGHTS``, matrices in ``dt`` and
             torch (out, in) layout, biases and LayerNorm affines float32

The masks are multipliers already divided by the keep probability; None
stands for all ones.  The weights are not split per head as the Pallas
kernel's are (that serves its compiler's lane alignment): head ``h`` is rows
``h·hd .. (h+1)·hd`` of ``wq`` and the same columns of ``wo``.

``enhanced_decoder_scan`` returns ``(h_tops (T,B,H) dt, enh (T,B,H) dt, attn
(T,B,L) f32)``.  For a CPU tensor it runs ``enhanced_scan_plain`` under
ordinary autograd.  For a CUDA tensor it launches ``csrc/enhanced_scan.cu``
(one cooperative launch over the card, rows in chunks of 16; E and H
divisible by 16, L <= 512, min(B, 16) x nh attention jobs at most one a
block), which always writes the five residual
trajectories as well; the backward is
``enhanced_scan_bwd_plain``, plain PyTorch over those residuals on either
device: the JAX package has no backward kernel here either (its custom VJP
is an XLA reverse scan).  Nothing falls back: a shape or layout the kernel
does not take raises.  ``layer_norm_partials`` mirrors the kernel's
LayerNorm statistics (per-block partials combined in block order) in plain
PyTorch for the CPU tests; nothing on the card calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops.lstm_scan import _DTYPES, _ptr_array

LN_EPS = 1e-5
NUM_LAYERS = 3

launches = 0  # forward launches of the enhanced recurrence

WEIGHTS = ("wqp", "bqp", "wq", "bq", "wo", "bo", "wg_c",
           "wih0", "whh0", "b0", "wih1", "whh1", "b1", "wih2", "whh2", "b2",
           "ln_g", "ln_b", "whg_h", "whg_c", "bhw", "wcp", "bcp")
_FLOAT32_WEIGHTS = ("bqp", "bq", "bo", "b0", "b1", "b2", "ln_g", "ln_b", "bhw",
                    "bcp")
OUTPUTS = ("h_tops", "enh", "attn", "h0s", "h1s", "c0s", "c1s", "c2s")


def weight_shapes(E: int, H: int) -> dict:
    return {"wqp": (E, H), "bqp": (E,), "wq": (E, E), "bq": (E,),
            "wo": (E, E), "bo": (E,), "wg_c": (E, E),
            "wih0": (4 * H, E), "whh0": (4 * H, H), "b0": (4 * H,),
            "wih1": (4 * H, H), "whh1": (4 * H, H), "b1": (4 * H,),
            "wih2": (4 * H, H), "whh2": (4 * H, H), "b2": (4 * H,),
            "ln_g": (NUM_LAYERS, H), "ln_b": (NUM_LAYERS, H),
            "whg_h": (H, H), "whg_c": (H, E), "bhw": (H,),
            "wcp": (H, E), "bcp": (H,)}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _layer_norm_stats(x):
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + LN_EPS)
    return (x - mu) * rstd, rstd


def layer_norm_partials(x, blocks: int = 132):
    """``_layer_norm_stats`` as the kernel takes it: block k of ``blocks``
    owns the units [k·H // blocks, (k+1)·H // blocks) and publishes their
    mean and sum of squared deviations; the consumer combines them in block
    order as mean = Σ n_k·mean_k / H and M2 = Σ (M2_k + n_k·(mean_k -
    mean)²), with rstd = rsqrt(M2 / H + eps).  A test helper: nothing on the
    card calls it."""
    H = x.shape[-1]
    cuts = [k * H // blocks for k in range(blocks + 1)]
    spans = [(lo, hi) for lo, hi in zip(cuts, cuts[1:]) if hi > lo]
    n = [float(hi - lo) for lo, hi in spans]
    means = [x[..., lo:hi].mean(-1, keepdim=True) for lo, hi in spans]
    m2s = [(x[..., lo:hi] - m).square().sum(-1, keepdim=True)
           for (lo, hi), m in zip(spans, means)]
    mu = sum(nk * m for nk, m in zip(n, means)) / H
    m2 = sum(q + nk * (m - mu).square() for nk, m, q in zip(n, means, m2s))
    rstd = torch.rsqrt(m2 / H + LN_EPS)
    return (x - mu) * rstd, rstd


def enhanced_scan_plain(embp, gate_w, k, v, amask, lmask, *weights,
                        acc_dtype: Optional[torch.dtype] = None):
    """Plain version of the forward kernel, differentiable by autograd.
    State stays in the accumulation dtype between steps (float32, or
    ``acc_dtype``); every matrix product reads its input rounded to the
    compute dtype, as the kernel does.  Returns the eight ``OUTPUTS``."""
    T, B, E = embp.shape
    nh, L, hd = k.shape[1], k.shape[2], k.shape[3]
    dt = embp.dtype
    acc = acc_dtype or torch.promote_types(torch.float32, dt)
    w = dict(zip(WEIGHTS, weights))
    H = w["whh0"].shape[1]
    scale = 1.0 / math.sqrt(hd)

    def mm(x, name):  # rounded input, weight in the compute dtype
        return x.to(dt).to(acc) @ w[name].to(dt).to(acc).t()

    bias = {n: w[n].to(acc) for n in _FLOAT32_WEIGHTS}
    kf, vf = k.to(acc), v.to(acc)
    zeros = torch.zeros(B, H, dtype=acc, device=embp.device)
    h, c = [zeros] * NUM_LAYERS, [zeros] * NUM_LAYERS
    out = {n: [] for n in OUTPUTS}
    for t in range(T):
        q = mm(h[2], "wqp") + bias["bqp"]
        qh = (mm(q, "wq") + bias["bq"]).reshape(B, nh, hd)
        s = torch.einsum("bnd,bnld->bnl", qh, kf) * scale
        wd = torch.softmax(s, dim=-1)
        if amask is not None:
            wd = wd * amask[t].to(acc)
        cat = torch.einsum("bnl,bnld->bnd", wd, vf).reshape(B, E)
        ctx = mm(cat, "wo") + bias["bo"]
        gate = torch.sigmoid(gate_w[t].to(acc) + mm(ctx, "wg_c"))
        x = gate * embp[t].to(acc) + (1.0 - gate) * ctx
        for li in range(NUM_LAYERS):
            gates = mm(x, f"wih{li}") + mm(h[li], f"whh{li}") + bias[f"b{li}"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c[li] = torch.sigmoid(f) * c[li] + torch.sigmoid(i) * torch.tanh(g)
            n, _ = _layer_norm_stats(torch.sigmoid(o) * torch.tanh(c[li]))
            x = n * bias["ln_g"][li] + bias["ln_b"][li]
            if lmask is not None:
                x = x * lmask[li, t].to(acc)
            h[li] = x
        ctxh = mm(ctx, "wcp") + bias["bcp"]
        ghw = torch.sigmoid(mm(h[2], "whg_h") + mm(ctx, "whg_c") + bias["bhw"])
        enh = ghw * h[2] + (1.0 - ghw) * ctxh
        for n, val in (("h_tops", h[2].to(dt)), ("enh", enh.to(dt)),
                       ("attn", wd.mean(1)), ("h0s", h[0].to(dt)),
                       ("h1s", h[1].to(dt)), ("c0s", c[0]), ("c1s", c[1]),
                       ("c2s", c[2])):
            out[n].append(val)
    return tuple(torch.stack(out[n]) for n in OUTPUTS)


def enhanced_scan_bwd_plain(res: Sequence[Optional[torch.Tensor]],
                            dh_tops: Optional[torch.Tensor],
                            denh: Optional[torch.Tensor],
                            dattns: Optional[torch.Tensor]
                            ) -> Tuple[Optional[torch.Tensor], ...]:
    """The reverse-time loop of ``pallas_enhanced._fused_enhanced_core_bwd``.
    ``res`` is the 37 residuals: embp, gate_w, k, v, amask, lmask, the 23
    weights, then the eight forward outputs.  Returns the gradients of the
    29 inputs (None for the two masks) in the accumulation dtype, weights in
    torch (out, in) layout.  Each step recomputes its forward intermediates
    from the stored trajectories in float32; the weight gradients are sums
    over all (t, b) rows and are taken as one product each after the loop."""
    embp, gate_w, k, v, amask, lmask = res[:6]
    w_in = res[6:6 + len(WEIGHTS)]
    h_tops, _, attns, h0s, h1s, c0s, c1s, c2s = res[6 + len(WEIGHTS):]
    T, B, E = embp.shape
    nh, L, hd = k.shape[1], k.shape[2], k.shape[3]
    acc = torch.promote_types(torch.float32, embp.dtype)
    dev = embp.device
    f = lambda x: x.to(acc)  # noqa: E731
    w = {n: f(t) for n, t in zip(WEIGHTS, w_in)}
    H = w["whh0"].shape[1]
    scale = 1.0 / math.sqrt(hd)
    kf, vf = f(k), f(v)
    hs, cs = (h0s, h1s, h_tops), (c0s, c1s, c2s)
    zeros = lambda *s: torch.zeros(*s, dtype=acc, device=dev)  # noqa: E731

    def cell_gates(x, hp, li):
        g = x @ w[f"wih{li}"].t() + hp @ w[f"whh{li}"].t() + w[f"b{li}"]
        i, fg, gg, o = g.chunk(4, dim=-1)
        return (torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(gg),
                torch.sigmoid(o))

    dh_c = [zeros(B, H) for _ in range(NUM_LAYERS)]
    dc_c = [zeros(B, H) for _ in range(NUM_LAYERS)]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    keep = {n: [] for n in (
        "dq", "h2p", "q", "dqh", "cat", "dctx", "dgp_att", "ctx", "dgp_hw",
        "h2", "dctxh", "dembp", "dg0", "dg1", "dg2", "x0", "x1", "x2", "hp0",
        "hp1", "hp2", "dyn0", "dyn1", "dyn2", "dy0", "dy1", "dy2")}
    for t in range(T - 1, -1, -1):
        prev = lambda x: f(x[t - 1]) if t > 0 else zeros(B, H)  # noqa: E731
        hp = [prev(x) for x in hs]
        cp = [prev(x) for x in cs]
        h_t = [f(x[t]) for x in hs]
        c_t = [f(x[t]) for x in cs]
        embp_t = f(embp[t])
        am = 1.0 if amask is None else f(amask[t])
        lm = [1.0 if lmask is None else f(lmask[li, t])
              for li in range(NUM_LAYERS)]

        # --- recompute the step's forward intermediates -----------------------
        q = hp[2] @ w["wqp"].t() + w["bqp"]
        qh = (q @ w["wq"].t() + w["bq"]).reshape(B, nh, hd)
        ws = torch.softmax(torch.einsum("bnd,bnld->bnl", qh, kf) * scale, -1)
        wd = ws * am
        cat = torch.einsum("bnl,bnld->bnd", wd, vf).reshape(B, E)
        ctx = cat @ w["wo"].t() + w["bo"]
        gate = torch.sigmoid(f(gate_w[t]) + ctx @ w["wg_c"].t())
        x_in = [gate * embp_t + (1.0 - gate) * ctx, h_t[0], h_t[1]]
        gts = [cell_gates(x_in[li], hp[li], li) for li in range(NUM_LAYERS)]
        norm = [_layer_norm_stats(gts[li][3] * torch.tanh(c_t[li]))
                for li in range(NUM_LAYERS)]
        ctxh = ctx @ w["wcp"].t() + w["bcp"]
        ghw = torch.sigmoid(h_t[2] @ w["whg_h"].t() + ctx @ w["whg_c"].t()
                            + w["bhw"])

        # --- highway ------------------------------------------------------------
        det = zeros(B, H) if denh is None else f(denh[t])
        dgp_hw = det * (h_t[2] - ctxh) * ghw * (1.0 - ghw)
        dctxh = det * (1.0 - ghw)
        dh = dh_c[2] + det * ghw + dgp_hw @ w["whg_h"]
        if dh_tops is not None:
            dh = dh + f(dh_tops[t])
        dctx = dgp_hw @ w["whg_c"] + dctxh @ w["wcp"]

        # --- layers 2, 1, 0: dropout -> LayerNorm -> cell --------------------
        dx = None
        for li in (2, 1, 0):
            if li < 2:
                dh = dh_c[li] + dx
            i, fg, gg, o = gts[li]
            n, rstd = norm[li]
            dy = dh * lm[li]
            g = dy * w["ln_g"][li]
            dn = g - g.mean(-1, keepdim=True)
            drh = rstd * (dn - n * (g * n).mean(-1, keepdim=True))
            tc = torch.tanh(c_t[li])
            dc = dc_c[li] + drh * o * (1.0 - tc * tc)
            dg = torch.cat([dc * gg * i * (1 - i), dc * cp[li] * fg * (1 - fg),
                            dc * i * (1 - gg * gg), drh * tc * o * (1 - o)], -1)
            dc_c[li] = dc * fg
            dx = dg @ w[f"wih{li}"]
            dh_c[li] = dg @ w[f"whh{li}"]
            for name, val in ((f"dg{li}", dg), (f"x{li}", x_in[li]),
                              (f"hp{li}", hp[li]), (f"dyn{li}", dy * n),
                              (f"dy{li}", dy)):
                keep[name].append(val)

        # --- gated fusion back to ctx, embp and gate_w ---------------------------
        dfused = dx
        dgp_att = dfused * (embp_t - ctx) * gate * (1.0 - gate)
        dctx = dctx + dfused * (1.0 - gate) + dgp_att @ w["wg_c"]

        # --- attention ---------------------------------------------------------------
        dcat = (dctx @ w["wo"]).reshape(B, nh, hd)
        dwd = torch.einsum("bnd,bnld->bnl", dcat, vf)
        if dattns is not None:
            dwd = dwd + f(dattns[t])[:, None, :] / nh
        dw = dwd * am
        ds = ws * (dw - (ws * dw).sum(-1, keepdim=True))
        dqh = torch.einsum("bnl,bnld->bnd", ds, kf) * scale
        dq = dqh.reshape(B, E) @ w["wq"]
        dh_c[2] = dh_c[2] + dq @ w["wqp"]
        dk += torch.einsum("bnl,bnd->bnld", ds, qh) * scale
        dv += torch.einsum("bnl,bnd->bnld", wd, dcat)

        for name, val in (("dq", dq), ("h2p", hp[2]), ("q", q),
                          ("dqh", dqh.reshape(B, E)), ("cat", cat),
                          ("dctx", dctx), ("dgp_att", dgp_att), ("ctx", ctx),
                          ("dgp_hw", dgp_hw), ("h2", h_t[2]), ("dctxh", dctxh),
                          ("dembp", dfused * gate)):
            keep[name].append(val)

    s = {n: torch.stack(x[::-1]).reshape(T * B, -1) for n, x in keep.items()}
    outer = lambda a, b: s[a].t() @ s[b]  # noqa: E731
    total = lambda a: s[a].sum(0)  # noqa: E731
    dweights = {
        "wqp": outer("dq", "h2p"), "bqp": total("dq"),
        "wq": outer("dqh", "q"), "bq": total("dqh"),
        "wo": outer("dctx", "cat"), "bo": total("dctx"),
        "wg_c": outer("dgp_att", "ctx"),
        "ln_g": torch.stack([total(f"dyn{li}") for li in range(NUM_LAYERS)]),
        "ln_b": torch.stack([total(f"dy{li}") for li in range(NUM_LAYERS)]),
        "whg_h": outer("dgp_hw", "h2"), "whg_c": outer("dgp_hw", "ctx"),
        "bhw": total("dgp_hw"), "wcp": outer("dctxh", "ctx"),
        "bcp": total("dctxh")}
    for li in range(NUM_LAYERS):
        dweights[f"wih{li}"] = outer(f"dg{li}", f"x{li}")
        dweights[f"whh{li}"] = outer(f"dg{li}", f"hp{li}")
        dweights[f"b{li}"] = total(f"dg{li}")
    return (s["dembp"].reshape(T, B, E), s["dgp_att"].reshape(T, B, E), dk, dv,
            None, None) + tuple(dweights[n] for n in WEIGHTS)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


HIDDEN_PER_BLOCK, E_PER_BLOCK = 6, 3  # csrc/enhanced_scan.cu caps
CHUNK_ROWS = 16  # batch rows a chunk: the M side of the kernel's mma tiles
MAX_L = 512   # keys of an attention row: one thread each
_LIB = None  # (library, its entry points with argtypes set), at first use


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.library("enhanced_scan")
        fns = {"blocks": lib.ic_enhanced_scan_blocks,
               "workspace": lib.ic_enhanced_scan_workspace_bytes,
               "scan": lib.ic_enhanced_scan}
        i, p = ctypes.c_int, ctypes.c_void_p
        fns["blocks"].restype = fns["scan"].restype = ctypes.c_int
        fns["workspace"].restype = ctypes.c_longlong
        fns["blocks"].argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        fns["workspace"].argtypes = [i] * 6
        fns["scan"].argtypes = [i, p, p] + [i] * 7 + [p]
        _LIB = lib, fns
    return _LIB


def _require_cuda(embp) -> None:
    if not embp.is_cuda:
        raise ValueError(f"enhanced scan kernel: the operands must be CUDA "
                         f"tensors; got embp on {embp.device}")


def _check_operands(embp, gate_w, k, v, amask, lmask, *weights):
    """Raise on what the kernel does not take; returns (T, B, L, E, H, nh)."""
    if len(weights) != len(WEIGHTS):
        raise ValueError(f"expected the {len(WEIGHTS)} weights {WEIGHTS}")
    _require_cuda(embp)
    if embp.dim() != 3 or k.dim() != 4:
        raise ValueError("enhanced scan kernel: embp must be (T, B, E) and k "
                         "(B, nh, L, hd)")
    dt, dev = embp.dtype, embp.device
    if dt not in _DTYPES:
        raise TypeError(f"enhanced scan kernel: dtype {dt} not supported")
    T, B, E = embp.shape
    nh, L, hd = k.shape[1], k.shape[2], k.shape[3]
    H = weights[WEIGHTS.index("whh0")].shape[1]
    if E % 16 or H % 16 or nh * hd != E or T < 1 or not 0 < L <= MAX_L:
        raise ValueError(f"enhanced scan kernel needs E and H divisible by 16, "
                         f"nh * hd == E and 0 < L <= {MAX_L}, got E={E}, "
                         f"H={H}, nh={nh}, hd={hd}, L={L}, T={T}")
    want = {"embp": ((T, B, E), dt), "gate_w": ((T, B, E), torch.float32),
            "k": ((B, nh, L, hd), dt), "v": ((B, nh, L, hd), dt),
            "amask": ((T, B, nh, L), torch.float32),
            "lmask": ((NUM_LAYERS, T, B, H), torch.float32)}
    want.update({n: (shape, torch.float32 if n in _FLOAT32_WEIGHTS else dt)
                 for n, shape in weight_shapes(E, H).items()})
    ops = (embp, gate_w, k, v, amask, lmask) + tuple(weights)
    for (name, (shape, dtype)), t in zip(want.items(), ops):
        if t is None and name in ("amask", "lmask"):
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected contiguous, 16-byte "
                             f"aligned {shape} {dtype} on {dev}")
    return T, B, L, E, H, nh


def enhanced_scan_blocks(dt, dev, L: int, E: int, H: int, nh: int) -> int:
    """The kernel's cooperative grid on this card (one block an SM); raises
    if the kernel does not fit or its blocks would own more columns than it
    takes."""
    _, fns = _library()
    return _build.cooperative_grid(
        ("enhanced_scan", dt, dev, L, E, H, nh),
        lambda smem: fns["blocks"](_DTYPES[dt], L, E, H, nh, smem),
        "enhanced scan kernel", (("H", H, HIDDEN_PER_BLOCK),
                                 ("E", E, E_PER_BLOCK)))


def enhanced_scan_cuda(embp, gate_w, k, v, amask, lmask, *weights):
    """Launch the cooperative forward kernel on the current stream.  Returns
    the eight ``OUTPUTS``."""
    global launches
    ops = (embp, gate_w, k, v, amask, lmask) + tuple(weights)
    T, B, L, E, H, nh = _check_operands(*ops)
    dt, dev = embp.dtype, embp.device
    lib, fns = _library()
    blocks = enhanced_scan_blocks(dt, dev, L, E, H, nh)
    jobs = min(B, CHUNK_ROWS) * nh
    if jobs > blocks:
        raise ValueError(f"enhanced scan kernel: {blocks} cooperative blocks "
                         f"hold one (row, head) attention job each, too few "
                         f"for min(B, {CHUNK_ROWS}) x nh = {jobs}")
    ws = torch.zeros(fns["workspace"](_DTYPES[dt], L, E, H, nh, blocks),
                     dtype=torch.uint8, device=dev)
    new = lambda n, d: torch.empty((T, B, n), dtype=d, device=dev)  # noqa: E731
    outs = (new(H, dt), new(H, dt), new(L, torch.float32), new(H, dt),
            new(H, dt), new(H, torch.float32), new(H, torch.float32),
            new(H, torch.float32))
    err = _build.call_on(dev, fns["scan"], _DTYPES[dt], _ptr_array(ops + outs),
                         ws.data_ptr(), blocks, T, B, L, E, H, nh)
    _build.check(lib, err, "enhanced_scan")
    launches += 1
    return outs


class _EnhancedScan(torch.autograd.Function):
    """The forward kernel under autograd with the plain reverse-time
    backward (``pallas_enhanced._get_fused_enhanced_core``)."""

    @staticmethod
    def forward(ctx, *ops):
        outs = enhanced_scan_cuda(*ops)
        if any(ctx.needs_input_grad):
            ctx.masks = ops[4:6]  # constants: no gradient, not saved tensors
            ctx.save_for_backward(*ops[:4], *ops[6:], *outs)
        ctx.set_materialize_grads(False)
        return outs[:3]

    @staticmethod
    def backward(ctx, dh_tops, denh, dattns):
        n_in = 6 + len(WEIGHTS)
        if dh_tops is None and denh is None and dattns is None:
            return (None,) * n_in
        saved = ctx.saved_tensors
        res = saved[:4] + tuple(ctx.masks) + saved[4:]
        grads = enhanced_scan_bwd_plain(res, dh_tops, denh, dattns)
        return tuple(g.to(op.dtype) if need and g is not None else None
                     for g, op, need in zip(grads, res, ctx.needs_input_grad))


def enhanced_decoder_scan(embp, gate_w, k, v, amask, lmask, *weights
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    ops = (embp, gate_w, k, v, amask, lmask) + tuple(weights)
    if embp.is_cuda:
        return _EnhancedScan.apply(*ops)
    if embp.device.type == "cpu":
        return enhanced_scan_plain(*ops)[:3]
    raise ValueError(f"enhanced_decoder_scan: unsupported device {embp.device}")
