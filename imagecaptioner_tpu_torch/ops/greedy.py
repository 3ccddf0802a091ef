"""Whole-loop greedy decode of the full student: the port of
``imagecaptioner_tpu/ops/pallas_greedy.py:pallas_greedy_decode_student``.

``greedy_operands`` gathers the decoder weights in their torch (out, in)
layout, which is also the layout the kernel reads (one warp per output row);
only the two LSTM bias vectors are summed and made float32.
``attention_feature_projection`` computes ``f_proj = feats·W_f + b_attn``
outside the loop, as ``pallas_greedy.py:270-274`` does.

``greedy_decode_plain`` is the plain PyTorch version: it keeps h/c in
float32 and rounds each matmul input to the activation dtype exactly where
the Pallas kernel does, so at float32 it is token-identical to both JAX
greedy paths.  Given a ``torch.Generator`` it samples from
softmax(logits / temperature) instead of taking the argmax.
``greedy_decode_cuda`` launches ``csrc/greedy_decode.cu`` and raises on
anything the kernel does not take.
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
MAX_SMEM_BYTES = 232448  # per block on the H100

launches = 0  # kernel launches by greedy_decode_cuda


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
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  Returns (B, max_length) int32;
    PAD at and after the first END."""
    B, L, E = feats.shape
    H = w["w_hh0"].shape[1]
    dt = feats.dtype

    def rd(x):  # round a float32 value to the activation dtype
        return x.to(dt).float()

    # weights in the activation dtype, widened once to float32 (transposed)
    wt = {k: w[k].to(dt).float().t() for k in
          ("w_ih0", "w_hh0", "w_ih1", "w_hh1", "fc1_w", "fc2_w")}
    w_h = w["w_attn"][:, :H].to(dt).float().t()
    w_e = w["w_comb"][:, :E].to(dt).float().t()
    w_c = w["w_comb"][:, E:].to(dt).float().t()

    def cell(x, h, c, layer):
        gates = (x @ wt[f"w_ih{layer}"] + h @ wt[f"w_hh{layer}"]
                 + w[f"b{layer}"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    fp, ft = f_proj.float(), feats.float()
    dev = feats.device
    h0 = c0 = h1 = c1 = torch.zeros(B, H, device=dev)
    tok = torch.full((B,), START, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_length), PAD, dtype=torch.int32, device=dev)
    for t in range(max_length):
        emb = w["emb"][tok].float()
        hw = rd(h1) @ w_h
        scores = torch.tanh(fp + hw[:, None, :]).sum(-1)
        attn = torch.softmax(scores, dim=-1)
        ctx = (attn[:, :, None] * ft).sum(1)
        x0 = rd(emb @ w_e + rd(ctx) @ w_c + w["b_comb"])
        h0, c0 = cell(x0, rd(h0), c0, 0)
        h1, c1 = cell(rd(h0), rd(h1), c1, 1)
        hid = torch.relu(rd(h1) @ wt["fc1_w"] + w["fc1_b"])
        logits = rd(hid) @ wt["fc2_w"] + w["fc2_b"]
        if temperature != 1.0:
            logits = logits / temperature
        if generator is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
        is_end = nxt == END
        out[:, t] = torch.where(done | is_end, PAD, nxt).to(torch.int32)
        done = done | is_end
        tok = torch.where(done, tok, nxt)
    return out


def greedy_decode_cuda(w: Operands, feats: torch.Tensor, f_proj: torch.Tensor,
                       *, max_length: int = 20, temperature: float = 1.0
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Returns (B,
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
    if E % 8 or H % 8:
        raise ValueError(f"greedy kernel needs E and H divisible by 8, "
                         f"got E={E}, H={H}")
    ops = dict(w, feats=feats, f_proj=f_proj)
    shapes = {
        "emb": (V, E), "f_proj": (B, L, E), "feats": (B, L, E),
        "w_attn": (E, H + E), "w_comb": (E, 2 * E), "b_comb": (E,),
        "w_ih0": (4 * H, E), "w_hh0": (4 * H, H), "b0": (4 * H,),
        "w_ih1": (4 * H, H), "w_hh1": (4 * H, H), "b1": (4 * H,),
        "fc1_w": (E, H), "fc1_b": (E,), "fc2_w": (V, E), "fc2_b": (V,),
    }
    for name in _ORDER:
        t = ops[name]
        want = torch.float32 if name in _FLOAT32_OPERANDS else dt
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != want or t.device != feats.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{want} on {feats.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _build.library("greedy_decode")
    lib.ic_greedy_smem_bytes.restype = ctypes.c_longlong
    lib.ic_greedy_smem_bytes.argtypes = [ctypes.c_int] * 4
    smem = lib.ic_greedy_smem_bytes(L, E, H, V)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"greedy kernel: {smem} bytes of shared memory for "
                         f"L={L}, E={E}, H={H}, V={V} exceed {MAX_SMEM_BYTES}")
    out = torch.empty((B, max_length), dtype=torch.int32, device=feats.device)
    ptrs = (ctypes.c_void_p * len(_ORDER))(*[ops[n].data_ptr() for n in _ORDER])
    fn = lib.ic_greedy_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dt], ctypes.cast(ptrs, ctypes.c_void_p),
                 out.data_ptr(), B, L, E, H, V, max_length,
                 float(temperature), stream)
    _build.check(lib, err, "greedy_decode")
    launches += 1
    return out
