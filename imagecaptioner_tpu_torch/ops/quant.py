"""Post-training int8 quantization for serving, the port of
``imagecaptioner_tpu/ops/quant.py``.

Scheme (JAX's): weights symmetric per output channel, ``scale =
amax(|w|) / 127`` over every axis but the first (1 where the amax is 0),
codes ``clip(round(w / scale), -127, 127)`` with round half to even;
activations symmetric per example (``amax`` over every axis but the
batch), or with one static ``x_scale`` baked in by calibration.  The
products are int8 x int8 with exact int32 sums, then JAX's epilogue
``float32(acc) * (s_x * w_scale)``, ``+ bias``, one rounding to the
activation's dtype: ``ops/int8.py``, whose CUDA kernels are
``csrc/int8_quant.cu`` (the activation's codes and scales) and
``csrc/int8_conv.cu`` (the products).  On the card an activation goes
through both; on the CPU through their plain versions
(``quantize_activation_plain``, ``int8_conv_plain``).

``quantize_params_int8`` returns a serving copy of a module tree in which
every ``Conv2d`` (4-D weight) and every ``Linear`` with a bias (2-D weight
with a bias) of at least ``MIN_QUANT_ELEMENTS`` weight elements loses its
``weight`` and holds the buffers ``weight_q`` (int8, torch layout),
``w_scale`` (float32, (O,)) and, once calibrated, ``x_scale`` (0-d
float32); with ``mha=True`` a packed ``in_proj_weight`` becomes
``in_proj_weight_q`` + ``in_proj_scale`` (+ ``in_proj_x_scale``).
Embeddings (2-D without a bias), norms and the LSTM's packed weights stay
float, as JAX's rule keeps them.  The names are JAX's, so a quantized JAX
tree converts to the copy's ``state_dict`` (``load_int8_state_dict``).
``core/modules.py`` (``Linear``, ``Conv2d``, ``multi_head_attention``) and
``models/transformer.py`` (``_proj_qkv``, ``_proj_q``) dispatch on those
buffers; a layer that reads ``.weight`` of a quantized module raises
``AttributeError`` rather than serve float weights.

Calibration (``calibrate_activation_scales``) runs the serving forward
inside a recording context, which keys each activation maximum by the int8
module about to multiply it (JAX keys by the identity of ``weight_q``); the
three projections of a packed in-projection fold into one scale, as JAX's
do.  The context refuses to nest.  It runs eagerly on the serving device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from imagecaptioner_tpu_torch.ops import int8 as I8
from imagecaptioner_tpu_torch.ops.int8 import (conv2d_int8_nhwc,
                                               dense_int8_rows, pack_weight)

# weights smaller than this stay float (JAX's MIN_QUANT_ELEMENTS)
MIN_QUANT_ELEMENTS = 4096


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: ``(w_q int8, scale float32
    (O,))``, reduced over every axis but the first (conv OIHW, dense
    (out, in))."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    shaped = scale.reshape((-1,) + (1,) * (w.dim() - 1))
    w_q = torch.clamp(torch.round(w / shaped), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_activation_int8(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-example dynamic int8: ``(x_q int8, scale float32
    (B, 1, ..., 1))``.  Both divisions are by tensors, which is the IEEE
    division on either device (CUDA turns a division by a Python scalar
    into a multiply by its reciprocal; the CPU and eager JAX divide)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def quantize_activation_plain(x: torch.Tensor,
                              x_scale: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel #12 (``ops/int8.quantize_activation_cuda``):
    x (B, ...) -> (codes int8 of x's shape, s_x float32 (B,)) per example,
    or (codes, ``x_scale``) under a calibrated static scale."""
    if x_scale is None:
        x_q, scale = quantize_activation_int8(x)
        return x_q, scale.reshape(-1)
    x_q = torch.clamp(torch.round(x.float() / x_scale), -127, 127
                      ).to(torch.int8)
    return x_q, x_scale


def _quantize_activation(owner: nn.Module, x: torch.Tensor,
                         x_scale: Optional[torch.Tensor]):
    """The calibrated static ``x_scale`` when there is one, else dynamic
    per-example quantization (one scale per ``x.shape[0]``), as codes of
    x's shape and layout and the scales flat; feeds the recorder when one
    is active.  A CUDA tensor goes through kernel #12 (contiguous in the
    layout the product reads), a CPU tensor through the plain version."""
    record_calibration_amax(owner, x)
    if x.is_cuda:
        return I8.quantize_activation_cuda(x.contiguous(), x.shape[0],
                                           x_scale)
    if x.device.type != "cpu":
        raise ValueError(f"int8 quantization: unsupported device {x.device}")
    return quantize_activation_plain(x, x_scale)


# ---------------------------------------------------------------------------
# Calibration of static activation scales
# ---------------------------------------------------------------------------

_CALIB: Optional[Dict[nn.Module, float]] = None


def record_calibration_amax(owner: nn.Module, x: torch.Tensor) -> None:
    """Inside ``recording()``, fold ``amax(|x|)`` into the record of the
    int8 module ``owner``; a no-op otherwise."""
    if _CALIB is None:
        return
    amax = float(x.detach().float().abs().amax())
    if amax > _CALIB.get(owner, 0.0):
        _CALIB[owner] = amax


@contextlib.contextmanager
def recording():
    """Collect activation maxima by int8 module; yields the record.  Not
    re-entrant."""
    global _CALIB
    if _CALIB is not None:
        raise RuntimeError("calibrate_activation_scales is not reentrant")
    _CALIB = {}
    try:
        yield _CALIB
    finally:
        _CALIB = None


def calibrate_activation_scales(qmodel: nn.Module,
                                run: Callable[[nn.Module], object], *,
                                margin: float = 1.0) -> nn.Module:
    """A copy of ``qmodel`` in which every int8 module that ``run(qmodel)``
    reached holds a static scale ``amax * margin / 127`` (1 where that is
    0): ``x_scale``, or ``in_proj_x_scale`` for a packed in-projection.
    Modules the run never reached keep dynamic quantization."""
    with recording() as rec, torch.no_grad():
        run(qmodel)
        amax = dict(rec)
    names = {id(m): n for n, m in qmodel.named_modules()}
    out = copy.deepcopy(qmodel)
    modules = dict(out.named_modules())
    for owner, a in amax.items():
        if id(owner) not in names:
            continue
        mod = modules[names[id(owner)]]
        a = a * margin
        key = "x_scale" if "weight_q" in mod._buffers else "in_proj_x_scale"
        ref = mod._buffers["weight_q" if key == "x_scale"
                           else "in_proj_weight_q"]
        mod.register_buffer(key, torch.tensor(
            a / 127.0 if a > 0 else 1.0, dtype=torch.float32,
            device=ref.device))
    return out


# ---------------------------------------------------------------------------
# Quantized serving copies
# ---------------------------------------------------------------------------


def is_quantized(mod: nn.Module) -> bool:
    return "weight_q" in mod._buffers or "in_proj_weight_q" in mod._buffers


def _swap(mod: nn.Module, name: str, q_name: str, s_name: str) -> None:
    w_q, scale = quantize_weight_int8(mod._parameters[name])
    delattr(mod, name)
    mod.register_buffer(q_name, w_q)
    mod.register_buffer(s_name, scale)


def _rewrite(mod: nn.Module, thr: int, mha: bool,
             exclude: Tuple[str, ...]) -> None:
    """JAX's dict walk, in place on a module tree."""
    names = set(mod._parameters) | set(mod._buffers) | set(mod._modules)
    if exclude and names & set(exclude):
        for name, child in mod.named_children():
            if name not in exclude:
                _rewrite(child, thr, mha, exclude)
        return
    p = mod._parameters
    if mha and p.get("in_proj_weight") is not None \
            and p["in_proj_weight"].numel() >= thr:
        _swap(mod, "in_proj_weight", "in_proj_weight_q", "in_proj_scale")
    else:
        w = p.get("weight")
        if w is not None and w.numel() >= thr and (
                w.dim() == 4 or (w.dim() == 2 and p.get("bias") is not None)):
            _swap(mod, "weight", "weight_q", "w_scale")
            return
    for child in mod.children():
        _rewrite(child, thr, mha, exclude)


def quantize_params_int8(module: nn.Module, *,
                         min_elements: Optional[int] = None,
                         mha: bool = False,
                         exclude: Tuple[str, ...] = ()) -> nn.Module:
    """A serving copy of ``module`` with JAX's rewrite applied (module
    docstring).  ``exclude`` names children whose subtrees stay float; a
    module with a direct child, parameter or buffer of such a name is not
    quantized itself, as JAX's dict walk leaves it."""
    out = copy.deepcopy(module)
    _rewrite(out, MIN_QUANT_ELEMENTS if min_elements is None
             else min_elements, mha, exclude)
    return out


def count_quantized(module: nn.Module) -> int:
    """Number of int8 weights in a quantized tree."""
    return sum(is_quantized(m) for m in module.modules())


def quantized_paths(module: nn.Module) -> Dict[str, str]:
    """Dotted module name -> which int8 weight it holds (``weight_q`` or
    ``in_proj_weight_q``): the set a test holds against JAX's tree."""
    return {name: ("weight_q" if "weight_q" in m._buffers
                   else "in_proj_weight_q")
            for name, m in module.named_modules() if is_quantized(m)}


def quantize_student_encoder_int8(student: nn.Module, *,
                                  exclude: Tuple[str, ...] = ()
                                  ) -> nn.Module:
    """Serving copy of a student with its CNN encoder quantized; the
    refinement, decoder and projectors stay float."""
    out = copy.deepcopy(student)
    _rewrite(out.encoder, MIN_QUANT_ELEMENTS, False, exclude)
    return out


def quantize_teacher_encoder_int8(teacher: nn.Module) -> nn.Module:
    """Serving copy of a teacher with its ViT encoder quantized; the
    transformer decoder stays float."""
    out = copy.deepcopy(teacher)
    _rewrite(out.encoder, MIN_QUANT_ELEMENTS, False, ())
    return out


def quantize_teacher_full_int8(teacher: nn.Module) -> nn.Module:
    """Serving copy of a teacher with encoder and transformer decoder
    quantized, packed in-projections included; embedding, norms and the
    KV caches stay float."""
    return quantize_params_int8(teacher, mha=True)


def load_int8_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor]
                         ) -> None:
    """Load a quantized (and possibly calibrated) state dict, e.g. a
    converted JAX tree, into a quantized copy of the same settings:
    the static scales the dict carries become buffers first, then
    ``load_state_dict(strict=True)``."""
    modules = dict(module.named_modules())
    for key, value in sd.items():
        head, _, leaf = key.rpartition(".")
        if leaf in ("x_scale", "in_proj_x_scale") and head in modules:
            modules[head].register_buffer(
                leaf, torch.empty((), dtype=torch.float32,
                                  device=value.device))
    module.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# The int8 forwards the modules dispatch to
# ---------------------------------------------------------------------------


def packed_weight(owner: nn.Module, w_q: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """The kernel's packed rows of ``w_q`` on the card, made once per
    weight and kept on ``owner``; None off the card."""
    if not w_q.is_cuda:
        return None
    key = (w_q.data_ptr(), w_q._version, w_q.device)
    cached = owner.__dict__.get("_int8_packed")
    if cached is None or cached[0] != key:
        cached = (key, pack_weight(w_q))
        owner.__dict__["_int8_packed"] = cached
    return cached[1]


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], x_scale: Optional[torch.Tensor],
                owner: nn.Module, packed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``dense_int8``: x (B, ..., K) -> (B, ..., O) in x's dtype."""
    x_q, s_x = _quantize_activation(owner, x, x_scale)
    lead, k = x.shape[:-1], x.shape[-1]
    y = dense_int8_rows(x_q.reshape(-1, k).contiguous(), w_q,
                        s_x.reshape(-1).contiguous(), w_scale,
                        None if bias is None else bias.float(),
                        out_dtype=x.dtype, packed=packed)
    return y.reshape(*lead, w_q.shape[0])


def dense_int8(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A quantized ``Linear``'s forward."""
    return int8_linear(x, mod.weight_q, mod.w_scale, mod.bias,
                       mod._buffers.get("x_scale"), mod,
                       packed_weight(mod, mod.weight_q))


def conv2d_int8(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A quantized ``Conv2d``'s forward: x (N, C, H, W) in any memory
    format -> (N, O, Ho, Wo) in x's dtype, channels-last in memory.  The
    activation is quantized as NHWC, the layout the product reads (no copy
    when x is channels-last)."""
    x_q, s_x = _quantize_activation(mod, x.permute(0, 2, 3, 1),
                                    mod._buffers.get("x_scale"))
    y = conv2d_int8_nhwc(
        x_q.contiguous(), mod.weight_q,
        s_x.reshape(-1).contiguous(), mod.w_scale,
        None if mod.bias is None else mod.bias.float(), stride=mod.stride,
        padding=mod.padding, groups=mod.groups, out_dtype=x.dtype,
        packed=packed_weight(mod, mod.weight_q))
    return y.permute(0, 3, 1, 2)


def in_proj_int8(mha: nn.Module, x: torch.Tensor, rows: slice
                 ) -> torch.Tensor:
    """Rows ``rows`` of a quantized packed in-projection applied to x, the
    activation recorded against the packed weight's module."""
    packed = packed_weight(mha, mha.in_proj_weight_q)
    return int8_linear(x, mha.in_proj_weight_q[rows],
                       mha.in_proj_scale[rows], mha.in_proj_bias[rows],
                       mha._buffers.get("in_proj_x_scale"), mha,
                       None if packed is None else packed[rows])
