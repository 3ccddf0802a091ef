"""Whole-loop greedy decode of the full and the compact student: the port of
``imagecaptioner_tpu/ops/pallas_greedy.py`` (``pallas_greedy_decode_student``;
``pallas_greedy_decode_compact`` at the end of this file).

``greedy_operands`` gathers the decoder weights in their torch (out, in)
layout, which is also the layout the kernel reads (each block stages the
rows it owns); only the two LSTM bias vectors are summed and made float32.
``attention_feature_projection`` computes ``f_proj = feats·W_f + b_attn``
outside the loop, as ``pallas_greedy.py:270-274`` does.

``greedy_decode_plain`` is the plain PyTorch version: it keeps h/c in
float32 and rounds each matmul input to the activation dtype exactly where
the Pallas kernel does, so at float32 it is token-identical to both JAX
greedy paths.  Given a ``torch.Generator`` it samples from
softmax(logits / temperature) instead of taking the argmax.
``greedy_decode_cuda`` launches ``csrc/greedy_decode.cu`` and
``greedy_decode_compact_cuda`` ``csrc/greedy_decode_compact.cu``, each one
cooperative kernel over the whole card (one block an SM, asked once per
device and shape), and each raises on anything its kernel does not take, a
card too small for it included.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from imagecaptioner_tpu_torch.data.vocabulary import END, PAD, START
from imagecaptioner_tpu_torch.ops import _build

Operands = Dict[str, torch.Tensor]
# kernel operand order (csrc/greedy_decode.cu, struct Args)
_ORDER = ("emb", "f_proj", "feats", "w_attn", "w_comb", "b_comb", "w_ih0",
          "w_hh0", "b0", "w_ih1", "w_hh1", "b1", "fc1_w", "fc1_b", "fc2_w",
          "fc2_b")
_FLOAT32_OPERANDS = ("b_comb", "b0", "b1", "fc1_b", "fc2_b")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by greedy_decode_cuda
launches_compact = 0  # kernel launches by greedy_decode_compact_cuda


def greedy_operands(decoder, dtype: torch.dtype) -> Operands:
    """Kernel operands from a ``models.lstm.FullDecoder``: weights in
    ``dtype`` and torch layout, biases float32."""
    if len(decoder.lstm) != 2:
        raise ValueError("the greedy kernel takes the 2-layer full decoder")
    l0, l1 = decoder.lstm
    op = decoder.output_projection
    w = lambda t: t.to(dtype).contiguous()  # noqa: E731
    return {
        "emb": w(decoder.embedding.weight),
        "w_attn": w(decoder.attention.weight),
        "b_attn": decoder.attention.bias,
        "w_comb": w(decoder.attention_combine.weight),
        "b_comb": decoder.attention_combine.bias.float().contiguous(),
        "w_ih0": w(l0.weight_ih), "w_hh0": w(l0.weight_hh),
        # summed in the parameter dtype, as pallas_lstm._split_params does
        "b0": (l0.bias_ih + l0.bias_hh).float().contiguous(),
        "w_ih1": w(l1.weight_ih), "w_hh1": w(l1.weight_hh),
        "b1": (l1.bias_ih + l1.bias_hh).float().contiguous(),
        "fc1_w": w(op.fc1.weight), "fc1_b": op.fc1.bias.float().contiguous(),
        "fc2_w": w(op.fc2.weight), "fc2_b": op.fc2.bias.float().contiguous(),
    }


def attention_feature_projection(w: Operands, feats: torch.Tensor
                                 ) -> torch.Tensor:
    """``f_proj = feats·W_f + b_attn`` in float32, rounded to feats.dtype."""
    H = w["w_hh0"].shape[1]
    w_f = w["w_attn"][:, H:].to(feats.dtype).float()
    y = torch.matmul(feats.float(), w_f.t()) + w["b_attn"].float()
    return y.to(feats.dtype).contiguous()


def greedy_decode_plain(w: Operands, feats: torch.Tensor, f_proj: torch.Tensor,
                        *, max_length: int = 20, temperature: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        acc_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  Returns (B, max_length) int32;
    PAD at and after the first END.  ``acc_dtype`` is the type the sums
    run in (float64 shows what summation order alone moves)."""
    B, L, E = feats.shape
    H = w["w_hh0"].shape[1]
    dt, acc = feats.dtype, acc_dtype

    def rd(x):  # round an accumulator value to the activation dtype
        return x.to(dt).to(acc)

    # weights in the activation dtype, widened once (transposed)
    wt = {k: w[k].to(dt).to(acc).t() for k in
          ("w_ih0", "w_hh0", "w_ih1", "w_hh1", "fc1_w", "fc2_w")}
    w_h = w["w_attn"][:, :H].to(dt).to(acc).t()
    w_e = w["w_comb"][:, :E].to(dt).to(acc).t()
    w_c = w["w_comb"][:, E:].to(dt).to(acc).t()
    b = {k: w[k].to(acc) for k in ("b_comb", "b0", "b1", "fc1_b", "fc2_b")}

    def cell(x, h, c, layer):
        gates = (x @ wt[f"w_ih{layer}"] + h @ wt[f"w_hh{layer}"]
                 + b[f"b{layer}"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    fp, ft = f_proj.to(acc), feats.to(acc)
    dev = feats.device
    h0 = c0 = h1 = c1 = torch.zeros(B, H, device=dev, dtype=acc)
    tok = torch.full((B,), START, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_length), PAD, dtype=torch.int32, device=dev)
    for t in range(max_length):
        emb = w["emb"][tok].to(acc)
        hw = rd(h1) @ w_h
        scores = torch.tanh(fp + hw[:, None, :]).sum(-1)
        attn = torch.softmax(scores, dim=-1)
        ctx = (attn[:, :, None] * ft).sum(1)
        x0 = rd(emb @ w_e + rd(ctx) @ w_c + b["b_comb"])
        h0, c0 = cell(x0, rd(h0), c0, 0)
        h1, c1 = cell(rd(h0), rd(h1), c1, 1)
        hid = torch.relu(rd(h1) @ wt["fc1_w"] + b["fc1_b"])
        logits = rd(hid) @ wt["fc2_w"] + b["fc2_b"]
        tok, done = next_token(logits, tok, done, out[:, t], temperature,
                               generator)
    return out


def next_token(logits, tok, done, out_t, temperature: float,
               generator: Optional[torch.Generator]):
    """One step's token choice, shared by the decode loops: argmax of
    float32 ``logits / temperature`` (the first index wins a tie), or a
    sample from their softmax when ``generator`` is given.  END and every
    later step write PAD into ``out_t``; a finished row keeps feeding its
    last real token.  Returns the new ``(tok, done)``."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    if generator is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                generator=generator)[:, 0]
    done = done | (nxt == END)
    out_t.copy_(torch.where(done, PAD, nxt).to(torch.int32))
    return torch.where(done, tok, nxt), done


def _check_operands(ops: Operands, order, float32_names, shapes,
                    feats: torch.Tensor) -> None:
    """Raise unless every kernel operand has its shape, its dtype (float32
    for the biases, ``feats.dtype`` otherwise) and ``feats``' device, and is
    contiguous and 16-byte aligned."""
    for name in order:
        t = ops[name]
        want = torch.float32 if name in float32_names else feats.dtype
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != want or t.device != feats.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{want} on {feats.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


HIDDEN_PER_BLOCK, E_PER_BLOCK, V_PER_BLOCK = 4, 2, 24  # csrc/greedy_decode.cu caps

_GREEDY = None  # (library, its entry points with argtypes set), at first use


def _greedy_library():
    global _GREEDY
    if _GREEDY is None:
        lib = _build.library("greedy_decode")
        fns = {"blocks": lib.ic_greedy_blocks,
               "workspace": lib.ic_greedy_workspace_bytes,
               "decode": lib.ic_greedy_decode}
        for f in ("blocks", "decode"):
            fns[f].restype = ctypes.c_int
        fns["workspace"].restype = ctypes.c_longlong
        fns["blocks"].argtypes = [ctypes.c_int] * 4 + \
            [ctypes.POINTER(ctypes.c_longlong)]
        fns["workspace"].argtypes = [ctypes.c_int] * 4
        fns["decode"].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        _GREEDY = lib, fns
    return _GREEDY


def greedy_blocks(dt: torch.dtype, dev: torch.device, L: int, E: int,
                  H: int, V: int) -> int:
    """The greedy kernel's cooperative grid on this card (one block an SM);
    raises if the kernel does not fit or its blocks would own more columns
    than it takes."""
    _, fns = _greedy_library()
    return _build.cooperative_grid(
        ("greedy_decode", dt, dev, L, E, H),
        lambda smem: fns["blocks"](_DTYPES[dt], L, E, H, smem),
        "greedy kernel", (("H", H, HIDDEN_PER_BLOCK), ("E", E, E_PER_BLOCK),
                          ("V", V, V_PER_BLOCK)))


def greedy_decode_cuda(w: Operands, feats: torch.Tensor, f_proj: torch.Tensor,
                       *, max_length: int = 20, temperature: float = 1.0
                       ) -> torch.Tensor:
    """Launch the cooperative CUDA kernel on the current stream (any B: rows
    beyond 32 run as further chunks inside the launch).  Returns (B,
    max_length) int32."""
    global launches
    if not feats.is_cuda or feats.dim() != 3:
        raise ValueError("feats must be a (B, L, E) CUDA tensor")
    dt = feats.dtype
    if dt not in _DTYPES:
        raise TypeError(f"greedy kernel: dtype {dt} not supported")
    B, L, E = feats.shape
    H = w["w_hh0"].shape[1]
    V = w["emb"].shape[0]
    if E % 16 or H % 16:
        raise ValueError(f"greedy kernel needs E and H divisible by 16, "
                         f"got E={E}, H={H}")
    ops = dict(w, feats=feats, f_proj=f_proj)
    _check_operands(ops, _ORDER, _FLOAT32_OPERANDS, {
        "emb": (V, E), "f_proj": (B, L, E), "feats": (B, L, E),
        "w_attn": (E, H + E), "w_comb": (E, 2 * E), "b_comb": (E,),
        "w_ih0": (4 * H, E), "w_hh0": (4 * H, H), "b0": (4 * H,),
        "w_ih1": (4 * H, H), "w_hh1": (4 * H, H), "b1": (4 * H,),
        "fc1_w": (E, H), "fc1_b": (E,), "fc2_w": (V, E), "fc2_b": (V,),
    }, feats)
    dev = feats.device
    lib, fns = _greedy_library()
    blocks = greedy_blocks(dt, dev, L, E, H, V)
    ws = torch.zeros(fns["workspace"](_DTYPES[dt], E, H, blocks),
                     dtype=torch.uint8, device=dev)
    out = torch.empty((B, max_length), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(_ORDER))(*[ops[n].data_ptr() for n in _ORDER])
    err = _build.call_on(dev, fns["decode"], _DTYPES[dt],
                         ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
                         ws.data_ptr(), blocks, B, L, E, H, V, max_length,
                         float(temperature))
    _build.check(lib, err, "greedy_decode")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# The compact student (1-layer LSTM, dot attention, additive fusion, a plain
# linear head)
# ---------------------------------------------------------------------------

# kernel operand order (csrc/greedy_decode_compact.cu, struct Args)
_COMPACT_ORDER = ("emb", "feats", "w_attn", "b_attn", "w_ih", "w_hh", "b",
                  "out_w", "out_b")
_COMPACT_FLOAT32 = ("b_attn", "b", "out_b")


def greedy_compact_operands(decoder, dtype: torch.dtype) -> Operands:
    """Kernel operands from a ``models.lstm.CompactDecoder``: weights in
    ``dtype`` and torch layout, biases float32."""
    if len(decoder.lstm) != 1:
        raise ValueError("the compact greedy kernel takes the 1-layer decoder")
    l0 = decoder.lstm[0]
    w = lambda t: t.to(dtype).contiguous()  # noqa: E731
    f = lambda t: t.float().contiguous()  # noqa: E731
    return {"emb": w(decoder.embedding.weight),
            "w_attn": w(decoder.attention.weight),
            "b_attn": f(decoder.attention.bias),
            "w_ih": w(l0.weight_ih), "w_hh": w(l0.weight_hh),
            "b": f(l0.bias_ih + l0.bias_hh),
            "out_w": w(decoder.output_projection.weight),
            "out_b": f(decoder.output_projection.bias)}


def greedy_decode_compact_plain(w: Operands, feats: torch.Tensor, *,
                                max_length: int = 20, temperature: float = 1.0,
                                generator: Optional[torch.Generator] = None,
                                acc_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain PyTorch version of the compact kernel.  Returns (B, max_length)
    int32; PAD at and after the first END.  ``acc_dtype`` is the type the
    sums run in (float64 shows what summation order alone moves)."""
    B = feats.shape[0]
    H = w["w_hh"].shape[1]
    dt, dev, acc = feats.dtype, feats.device, acc_dtype

    def rd(x):
        return x.to(dt).to(acc)

    Wa, Wih, Whh, Wout = (w[k].to(dt).to(acc).t()
                          for k in ("w_attn", "w_ih", "w_hh", "out_w"))
    ft = feats.to(acc)
    h = c = torch.zeros(B, H, device=dev, dtype=acc)
    tok = torch.full((B,), START, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_length), PAD, dtype=torch.int32, device=dev)
    for t in range(max_length):
        hp = rd(h) @ Wa + w["b_attn"]
        attn = torch.softmax((hp[:, None, :] * ft).sum(-1), dim=-1)
        ctx = (attn[:, :, None] * ft).sum(1)
        x0 = rd(w["emb"][tok].to(acc) + ctx)
        i, f, g, o = (x0 @ Wih + rd(h) @ Whh + w["b"]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        logits = rd(h) @ Wout + w["out_b"]
        tok, done = next_token(logits, tok, done, out[:, t], temperature,
                               generator)
    return out


COMPACT_HIDDEN_PER_BLOCK, COMPACT_E_PER_BLOCK, COMPACT_V_PER_BLOCK = 4, 2, 24
COMPACT_CHUNK = 32  # batch rows a chunk, each attended by a block of its own
# (csrc/greedy_decode_compact.cu caps)

_COMPACT = None  # (library, its entry points with argtypes set), at first use


def _compact_library():
    global _COMPACT
    if _COMPACT is None:
        lib = _build.library("greedy_decode_compact")
        fns = {"blocks": lib.ic_greedy_compact_blocks,
               "workspace": lib.ic_greedy_compact_workspace_bytes,
               "decode": lib.ic_greedy_decode_compact}
        i, p = ctypes.c_int, ctypes.c_void_p
        fns["blocks"].argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        fns["workspace"].argtypes = [i] * 4
        fns["decode"].argtypes = [i, p, p, p] + [i] * 7 + [ctypes.c_float, p]
        fns["blocks"].restype = fns["decode"].restype = i
        fns["workspace"].restype = ctypes.c_longlong
        _COMPACT = lib, fns
    return _COMPACT


def _require_cuda(feats: torch.Tensor) -> None:
    if not feats.is_cuda:
        raise ValueError(f"feats must be a CUDA tensor; got one on "
                         f"{feats.device}")


def greedy_compact_blocks(dt: torch.dtype, dev: torch.device, L: int, E: int,
                          H: int, V: int) -> int:
    """The compact greedy kernel's cooperative grid on this card (one block
    an SM); raises if the kernel does not fit, if its blocks would own more
    columns than it takes, or if there are fewer blocks than the rows of a
    chunk."""
    _, fns = _compact_library()
    n = _build.cooperative_grid(
        ("greedy_decode_compact", dt, dev, L, E, H),
        lambda smem: fns["blocks"](_DTYPES[dt], L, E, H, smem),
        "compact greedy kernel", (("H", H, COMPACT_HIDDEN_PER_BLOCK),
                                  ("E", E, COMPACT_E_PER_BLOCK),
                                  ("V", V, COMPACT_V_PER_BLOCK)))
    if n < COMPACT_CHUNK:
        raise ValueError(f"compact greedy kernel: {n} cooperative blocks, "
                         f"fewer than the {COMPACT_CHUNK} rows of a chunk "
                         f"that each take a block")
    return n


def greedy_decode_compact_cuda(w: Operands, feats: torch.Tensor, *,
                               max_length: int = 20, temperature: float = 1.0
                               ) -> torch.Tensor:
    """Launch the cooperative ``csrc/greedy_decode_compact.cu`` on the
    current stream (any B: rows beyond 32 run as further chunks inside the
    launch).  Returns (B, max_length) int32."""
    global launches_compact
    _require_cuda(feats)
    if feats.dim() != 3:
        raise ValueError("feats must be (B, L, E)")
    dt = feats.dtype
    if dt not in _DTYPES:
        raise TypeError(f"compact greedy kernel: dtype {dt} not supported")
    B, L, E = feats.shape
    H, V = w["w_hh"].shape[1], w["emb"].shape[0]
    if E % 16 or H % 16:
        raise ValueError(f"compact greedy kernel needs E and H divisible by "
                         f"16, got E={E}, H={H}")
    ops = dict(w, feats=feats)
    _check_operands(ops, _COMPACT_ORDER, _COMPACT_FLOAT32, {
        "emb": (V, E), "feats": (B, L, E), "w_attn": (E, H), "b_attn": (E,),
        "w_ih": (4 * H, E), "w_hh": (4 * H, H), "b": (4 * H,),
        "out_w": (V, H), "out_b": (V,)}, feats)
    dev = feats.device
    lib, fns = _compact_library()
    blocks = greedy_compact_blocks(dt, dev, L, E, H, V)
    ws = _build.workspace(
        ("greedy_decode_compact", dt, dev, E, H, blocks, _build.stream_of(dev)),
        lambda: fns["workspace"](_DTYPES[dt], E, H, blocks), dev)
    out = torch.empty((B, max_length), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(_COMPACT_ORDER))(
        *[ops[n].data_ptr() for n in _COMPACT_ORDER])
    err = _build.call_on(dev, fns["decode"], _DTYPES[dt],
                         ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
                         ws.data_ptr(), blocks, B, L, E, H, V, max_length,
                         float(temperature))
    _build.check(lib, err, "greedy_decode_compact")
    launches_compact += 1
    return out
