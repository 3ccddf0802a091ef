"""int8 serving's two kernels: the int8 x int8 -> int32 convolution and dense
products with JAX's epilogue (#11, ``csrc/int8_conv.cu``), and the
activation quantization before them (#12, ``csrc/int8_quant.cu``).

Neither replaces a Pallas kernel: ``imagecaptioner_tpu/ops/quant.py`` hands
both to XLA (``conv_general_dilated`` / ``dot_general`` with
``preferred_element_type=int32``; the amax, divide, round and clip of
``quantize_activation_int8`` and ``_quantize_activation``), and PyTorch's
CUDA operators offer no such product (``F.conv2d`` refuses int8;
``torch._int_mm`` has no groups or windows).  The products compute

    acc = sum x_q * w_q                      exactly, in int32
    out = (float32(acc) * (s_x * w_scale) [+ bias]) rounded to ``out_dtype``

with each operation rounded on its own, in JAX's order
(``quant.py:307-310``), so kernel and plain version agree bit for bit.

Layouts: activations NHWC int8 (a dense input is its (M, 1, 1, K) map);
weights torch-layout (O, C/groups, kh, kw) int8, which ``pack_weight``
reorders once into the kernel's (O, Kp) rows of (kh, kw, C/groups), zero
up to a multiple of 128 (the kernel's stage depth); the kernel reads them
through a TMA descriptor (``weight_map``), made once per packed weight and
tile width.  ``s_x`` holds one float32 scale per ``rows_per_scale``
output rows: per example (dynamic quantization) or one for all (a
calibrated static scale).  The tile width is the shape's (``tile_width``),
not an option.

``conv2d_int8_nhwc`` and ``dense_int8_rows`` dispatch on the device: a CPU
tensor takes the plain version (integer sums taken exactly in float64, which
holds every sum here below 2^53), a CUDA tensor the kernel, which raises on
what it does not take.  ``quantize_activation_cuda`` is #12's wrapper; its
plain version is ``ops/quant.quantize_activation_plain``.  Nothing falls
back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from imagecaptioner_tpu_torch.ops import _build

K_ALIGN = 128  # the kernel's stage depth: packed rows are a multiple of it
BM = 128  # output rows a tile of the product
_OUT = {torch.bfloat16: 1, torch.float32: 0}
_IN = {torch.bfloat16: 1, torch.float32: 0}

launches = 0  # kernel launches by int8_conv_cuda
quant_launches = 0  # kernel launches by quantize_activation_cuda
_KERNEL = None  # (library, product, weight map), argtypes set, at first use
_QUANT = None  # (library, entry point), at first use
_MAPS: Dict[tuple, ctypes.Array] = {}  # tensor maps by weight and tile
_SMS: Dict[int, int] = {}  # SM count by device index


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry points' parameters, in order (tests hold them to the sources)
ARGTYPES = {
    "ic_int8_conv": [_P] * 7 + [_I] * 14 + [_P],
    "ic_int8_weight_map": [_P] + [_I] * 3 + [_P],
    "ic_int8_quantize": [_P, _I, _LL, _LL] + [_P] * 5,
}


def _entry(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES[name]
    return fn


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = _build.library("int8_conv")
        _KERNEL = (lib, _entry(lib, "ic_int8_conv"),
                   _entry(lib, "ic_int8_weight_map"))
    return _KERNEL


def _quant_kernels():
    global _QUANT
    if _QUANT is None:
        lib = _build.library("int8_quant")
        _QUANT = lib, _entry(lib, "ic_int8_quantize")
    return _QUANT


def tile_width(m: int, og: int, groups: int, sms: int) -> int:
    """The product's tile width for M rows and ``og`` output channels a
    group on a card of ``sms`` SMs: 64 where a group has at most 64, or
    where 128-wide tiles would leave SMs idle (small M: a beam step's dense
    layers, the projection, ResNet's last stage), else 128."""
    if og <= 64:
        return 64
    return 128 if -(-m // BM) * -(-og // 128) * groups >= sms else 64


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def weight_map(packed: torch.Tensor, bn: int) -> ctypes.Array:
    """The TMA descriptor (128 bytes) of ``packed`` (O, Kp) int8 rows on the
    card for tiles of ``bn`` rows, made once per (rows, tile width): a
    descriptor holds only the address, the shape and the tile, all in the
    key, so a cached one is never stale."""
    if not packed.is_cuda:
        raise ValueError("weight_map: the packed weight must be a CUDA "
                         f"tensor, got one on {packed.device}")
    key = (packed.data_ptr(), packed.shape[0], packed.shape[1], bn,
           packed.device.index)
    if key not in _MAPS:
        _, _, encode = _kernel()
        buf = ctypes.create_string_buffer(128)
        with torch.cuda.device(packed.device):
            err = encode(packed.data_ptr(), packed.shape[0], packed.shape[1],
                         bn, buf)
        if err != 0:
            raise RuntimeError(
                "int8_conv: cuTensorMapEncodeTiled " + (
                    "not found in libcuda" if err == -1
                    else f"returned CUresult {err}") + f" for the packed "
                f"weight {tuple(packed.shape)}, tile {bn}")
        _MAPS[key] = buf
    return _MAPS[key]


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(O, C/g, kh, kw) int8, or a dense (O, K) -> the kernel's (O, Kp) rows
    in (kh, kw, C/g) order, zero from K = kh*kw*C/g up to Kp, a multiple of
    128."""
    o = w_q.shape[0]
    rows = (w_q if w_q.dim() == 2
            else w_q.permute(0, 2, 3, 1).reshape(o, -1))
    k = rows.shape[1]
    return F.pad(rows, (0, -(-k // K_ALIGN) * K_ALIGN - k)).contiguous()


def _epilogue(acc: torch.Tensor, s_rows: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype
              ) -> torch.Tensor:
    """acc (M, O) float32 holding exact integers; s_rows (M,) float32."""
    y = acc * (s_rows[:, None] * w_scale[None, :])
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor], *,
                    stride: int = 1, padding: int = 0, groups: int = 1,
                    out_dtype: torch.dtype = torch.float32,
                    rows_per_scale: int) -> torch.Tensor:
    """Plain PyTorch version: x_q (N, H, W, C) int8, w_q (O, C/g, kh, kw)
    int8 -> (N, Ho, Wo, O) ``out_dtype``.  The windows are unfolded and
    multiplied group by group in float64, whose sums are exact below 2^53
    (K products of at most 127^2 each): plain products, no convolution
    library."""
    n, h, w, c = x_q.shape
    o, cg, kh, kw = w_q.shape
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride, padding)
    cols = F.unfold(x_q.permute(0, 3, 1, 2).double(), (kh, kw),
                    padding=padding, stride=stride)     # (N, C*kh*kw, L)
    cols = cols.reshape(n, groups, cg * kh * kw, ho * wo)
    wg = w_q.double().reshape(groups, o // groups, cg * kh * kw)
    acc = torch.einsum("gok,ngkl->nlgo", wg, cols).reshape(-1, o).float()
    s_rows = s_x.float().reshape(-1).repeat_interleave(rows_per_scale)
    return _epilogue(acc, s_rows, w_scale.float(), bias,
                     out_dtype).reshape(n, ho, wo, o)


def int8_conv_cuda(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                   w_scale: torch.Tensor, bias: Optional[torch.Tensor], *,
                   stride: int = 1, padding: int = 0, groups: int = 1,
                   out_dtype: torch.dtype = torch.float32,
                   rows_per_scale: int,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/int8_conv.cu`` on the current stream; ``packed`` is
    ``pack_weight(w_q)`` when the caller keeps it."""
    global launches
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype}, "
                        f"{w_q.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"out_dtype {out_dtype}: only float32 and bfloat16")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError("x_q must be (N, H, W, C) and w_q (O, C/g, kh, kw)")
    n, h, w, c = x_q.shape
    o, cg, kh, kw = w_q.shape
    if c % groups or o % groups or cg != c // groups:
        raise ValueError(f"groups={groups} does not split C={c}, O={o} with "
                         f"a weight of {cg} input channels")
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride, padding)
    m = n * ho * wo
    if ho <= 0 or wo <= 0 or m >= 2 ** 31 or m * o >= 2 ** 40:
        raise ValueError(f"output {n}x{ho}x{wo}x{o} out of the kernel's range")
    if rows_per_scale <= 0 or s_x.numel() * rows_per_scale != m:
        raise ValueError(f"{s_x.numel()} scales of {rows_per_scale} rows do "
                         f"not cover {m} output rows")
    if packed is None:
        packed = pack_weight(w_q)
    kp = packed.shape[1]
    if packed.shape[0] != o or kp % K_ALIGN or kp < kh * kw * cg:
        raise ValueError(f"packed weight {tuple(packed.shape)} does not fit "
                         f"w_q {tuple(w_q.shape)}")
    tensors = [x_q, packed, s_x, w_scale] + ([] if bias is None else [bias])
    dev = x_q.device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("int8_conv_cuda: every operand on one CUDA device")
    if s_x.dtype != torch.float32 or w_scale.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("s_x, w_scale and bias must be float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("int8_conv_cuda: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (x_q, packed)):
        raise ValueError("x_q and the packed weight must be 16-byte aligned")
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=dev)
    lib, fn, _ = _kernel()
    bn = tile_width(m, o // groups, groups, _sms(dev))
    wmap = None if cg == 1 and o == groups else weight_map(packed, bn)
    err = _build.call_on(
        dev, fn, x_q.data_ptr(), packed.data_ptr(), wmap, s_x.data_ptr(),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), _OUT[out_dtype], n, h, w, c, o, kh, kw, stride,
        padding, groups, kp, rows_per_scale, bn)
    _build.check(lib, err, "int8_conv")
    launches += 1
    return out


def quantize_activation_cuda(x: torch.Tensor, n_examples: int,
                             x_scale: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/int8_quant.cu`` on the current stream: x (bf16 or
    float32, contiguous, on the card) of ``n_examples`` examples of equal
    size -> (codes int8 of x's shape, s_x float32 (n_examples,)) with
    per-example scales (two launches: the amax pass, the quantizing pass),
    or (codes, ``x_scale``) under a static scale (one launch).  One C call
    either way: the library enqueues the passes (and the slots' memset)."""
    global quant_launches
    if not x.is_cuda:
        raise ValueError("quantize_activation_cuda: x must be a CUDA tensor, "
                         f"got one on {x.device}")
    if x.dtype not in _IN:
        raise TypeError(f"quantize_activation_cuda: x is {x.dtype}; only "
                        "bfloat16 and float32")
    if not x.is_contiguous():
        raise ValueError("quantize_activation_cuda: x must be contiguous")
    numel, dev = x.numel(), x.device
    if n_examples <= 0 or numel % n_examples or n_examples > 65535:
        raise ValueError(f"{numel} elements are not {n_examples} examples of "
                         "equal size, at most 65,535 (the kernel's grid)")
    if x_scale is not None and (not x_scale.is_cuda or x_scale.device != dev
                                or x_scale.dtype != torch.float32
                                or x_scale.numel() != 1):
        raise ValueError("x_scale must be one float32 on x's device")
    x_q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    lib, quant = _quant_kernels()
    if x_scale is not None:
        err = _build.call_on(dev, quant, x.data_ptr(), _IN[x.dtype],
                             n_examples, numel // n_examples, None,
                             x_scale.data_ptr(), x_q.data_ptr(), None)
        _build.check(lib, err, "int8_quantize")
        quant_launches += 1
        return x_q, x_scale
    # the amax slots (bits of non-negative floats) and the scales
    buf = torch.empty(2 * n_examples, dtype=torch.float32, device=dev)
    s_x = buf[n_examples:]
    err = _build.call_on(dev, quant, x.data_ptr(), _IN[x.dtype], n_examples,
                         numel // n_examples, buf.data_ptr(), None,
                         x_q.data_ptr(), s_x.data_ptr())
    _build.check(lib, err, "int8_quantize")
    quant_launches += 2
    return x_q, s_x


def _dispatch(x_q, w_q, s_x, w_scale, bias, packed, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors; one
    scale of ``s_x`` per ``M / len(s_x)`` consecutive output rows."""
    n, h, w, _ = x_q.shape
    _, _, kh, kw_ = w_q.shape
    m = (n * out_size(h, kh, kw["stride"], kw["padding"])
         * out_size(w, kw_, kw["stride"], kw["padding"]))
    kw["rows_per_scale"] = m // max(s_x.numel(), 1)
    if x_q.is_cuda:
        return int8_conv_cuda(x_q, w_q, s_x, w_scale, bias, packed=packed,
                              **kw)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, s_x, w_scale, bias, **kw)
    raise ValueError(f"int8 product: unsupported device {x_q.device}")


def conv2d_int8_nhwc(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                     w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, stride: int = 1, padding: int = 0, groups: int = 1,
                     out_dtype: torch.dtype = torch.float32,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q (N, H, W, C) int8 with ``s_x`` (N,) per example or (1,) static
    -> (N, Ho, Wo, O) ``out_dtype``."""
    return _dispatch(x_q, w_q, s_x, w_scale, bias, packed, stride=stride,
                     padding=padding, groups=groups, out_dtype=out_dtype)


def dense_int8_rows(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    *, out_dtype: torch.dtype = torch.float32,
                    packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q (M, K) int8, w_q (O, K) int8, ``s_x`` (G,) one scale per M / G
    consecutive rows -> (M, O) ``out_dtype``: the 1x1 convolution over the
    (M, 1, 1, K) map."""
    m, k = x_q.shape
    y = _dispatch(x_q.reshape(m, 1, 1, k), w_q.reshape(w_q.shape[0], k, 1, 1),
                  s_x, w_scale, bias, packed, stride=1, padding=0, groups=1,
                  out_dtype=out_dtype)
    return y.reshape(m, -1)
