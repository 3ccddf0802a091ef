"""int8 serving's two kernels on the CPU: the activation quantization (#12,
``csrc/int8_quant.cu``) and the products (#11, ``csrc/int8_conv.cu``).

The kernels run only on the card (``chip_smoke.py`` holds them bit for bit
against their plain versions there).  Here: the quantization's plain
version (``ops/quant.quantize_activation_plain``, what a CPU tensor takes)
against JAX's ``quantize_activation_int8`` and ``_quantize_activation``
run eagerly, at exact ties and all-zero examples; the dispatch that sends a
CPU tensor to the plain versions and never to a kernel; the CUDA entry
points refusing CPU tensors; and the shapes' choice of the product's tile
width.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.ops import quant as JQ
from imagecaptioner_tpu_torch.core.modules import Conv2d
from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops import int8 as I8
from imagecaptioner_tpu_torch.ops import quant as Q


def _ties_and_zeros(static: bool) -> np.ndarray:
    """(3, 2, 2, 32) float32: example 0 holds exact ties of the rounding
    (k + 0.5 under the dynamic scale 127 / 127 = 1, or under the static
    scale 0.5) and its amax 127 (dynamic) or a value that clips;
    example 1 is all zero (dynamic scale 1); example 2 is seeded noise."""
    ties = (np.arange(-63, 64, dtype=np.float32) + 0.5) * (0.5 if static
                                                           else 1.0)
    row = np.zeros(128, np.float32)
    row[:ties.size] = ties
    row[-1] = 127.0 if not static else 100.0
    x = np.stack([row, np.zeros(128, np.float32),
                  np.random.default_rng(5).standard_normal(128).astype(
                      np.float32) * 3])
    return x.reshape(3, 2, 2, 32)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_quantization_is_jaxs_at_ties_and_zeros(dtype, static):
    """``quantize_activation_plain`` (the kernel's plain version) is JAX's
    eager ``quantize_activation_int8`` (dynamic) or ``_quantize_activation``
    under ``x_scale`` (static) bit for bit: codes and scales, ties rounded
    half to even, an all-zero example scaled by 1."""
    x = _ties_and_zeros(static)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, xp = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(pdt)
    assert np.array_equal(np.asarray(xj.astype(jnp.float32)),
                          xp.float().numpy())      # ties survive the dtype
    with jax.disable_jit():
        if static:
            jq, js = JQ._quantize_activation(
                {"weight_q": jnp.zeros(1), "x_scale": jnp.float32(0.5)}, xj)
        else:
            jq, js = JQ.quantize_activation_int8(xj)
    pq, ps = Q.quantize_activation_plain(
        xp, torch.tensor(0.5) if static else None)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().reshape(-1),
                                  np.asarray(js).reshape(-1))
    codes = pq.numpy().reshape(3, -1)
    ties = codes[0, :127].astype(np.int32)   # x / scale = -62.5 ... 63.5
    assert ties[61:66].tolist() == [-2, 0, 0, 2, 2]    # half to even
    assert codes[0, -1] == 127 and not codes[1].any()
    if static:
        assert ps.numel() == 1
    else:
        assert float(ps[0]) == 1.0 and float(ps[1]) == 1.0


def test_cpu_activation_never_reaches_a_kernel(monkeypatch):
    """On the CPU the dispatch takes the plain versions: a quantized
    convolution on a channels-last input equals the one on a contiguous
    input, codes laid out NHWC as the product reads them, and neither
    CUDA wrapper is called."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper was called for a CPU tensor")
    monkeypatch.setattr(I8, "quantize_activation_cuda", refuse)
    monkeypatch.setattr(I8, "int8_conv_cuda", refuse)
    rng = np.random.default_rng(2)
    m = Conv2d(16, 24, 3, padding=1)
    m.weight.data = torch.from_numpy(
        rng.standard_normal(m.weight.shape).astype(np.float32) * 0.1)
    qm = Q.quantize_params_int8(m, min_elements=1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 9, 9)).astype(
        np.float32))
    y = qm(x)
    y_cl = qm(x.contiguous(memory_format=torch.channels_last))
    assert torch.equal(y, y_cl)
    x_q, s_x = Q._quantize_activation(qm, x.permute(0, 2, 3, 1), None)
    ref_q, ref_s = Q.quantize_activation_int8(x)
    assert torch.equal(x_q, ref_q.permute(0, 2, 3, 1))
    assert torch.equal(s_x, ref_s.reshape(-1)) and s_x.shape == (2,)


def test_cuda_entry_points_refuse_cpu_tensors():
    """The quantization kernel's wrapper and the weight's TMA descriptor
    refuse CPU tensors (before building anything), naming CUDA."""
    x = torch.zeros(2, 4, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        I8.quantize_activation_cuda(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        I8.quantize_activation_cuda(x, 2, torch.tensor(0.5))
    with pytest.raises(ValueError, match="CUDA"):
        I8.weight_map(I8.pack_weight(torch.zeros(8, 16, dtype=torch.int8)),
                      64)


@pytest.mark.parametrize("m, og, groups, want", [
    (100352, 256, 1, 128),   # ResNet layer1 1x1 at B=32: 1,568 wide tiles
    (100352, 64, 1, 64),     # 64 output channels
    (1568, 2048, 1, 128),    # layer4 1x1 512->2048: 208 wide tiles
    (1568, 512, 1, 64),      # layer4 3x3: 52 wide tiles leave SMs idle
    (1568, 256, 1, 64),      # the projection
    (80, 1152, 1, 64),       # a beam step's packed in-projection
    (338, 18, 2, 64),        # grouped
])
def test_tile_width_follows_the_shape(m, og, groups, want):
    """The product's tile width is the shape's: 64 columns where a group
    has at most 64 or where 128-wide tiles number fewer than the SMs."""
    assert I8.tile_width(m, og, groups, 132) == want


C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("source, name", [
    ("int8_conv", "ic_int8_conv"), ("int8_conv", "ic_int8_weight_map"),
    ("int8_quant", "ic_int8_quantize")])
def test_entry_point_types_are_the_sources(source, name):
    """The ctypes parameter list of each entry point is its C signature's
    (a pointer is c_void_p, an int c_int, a long long c_longlong): a count
    off by one passes the stream where an int was expected."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                       re.S).group(1)
    want = []
    for param in params.split(","):
        decl = " ".join(param.split()[:-1]).replace("const ", "")
        want.append(ctypes.c_void_p if "*" in param
                    else C_TYPES[decl])
    assert I8.ARGTYPES[name] == want
