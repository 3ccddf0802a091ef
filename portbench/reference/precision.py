"""Roundings of a product's operands: the reference's (none) and the
controls' lower precisions, emulated so that the products still run in
float32."""

from __future__ import annotations

from typing import Callable

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to TF32's 10 mantissa bits, to nearest (ties away)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale per tensor (amax to 448)."""
    xf = x.float()
    s = xf.abs().amax().clamp(min=1e-30) / 448.0
    return (xf / s).to(torch.float8_e4m3fn).float() * s


ROUNDINGS = {"float32": f32, "tf32": tf32, "fp8": fp8}
