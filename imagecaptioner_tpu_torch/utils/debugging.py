"""Debugging hooks (``imagecaptioner_tpu/utils/debugging.py``).

  * ``enable_nan_checks()``: autograd's anomaly mode, which names the
    forward operation whose backward produced a NaN (JAX's
    ``jax_debug_nans``);
  * ``assert_shape`` / ``assert_dtype``: structural checks with the JAX
    module's messages (``None`` in a shape is a wildcard);
  * ``check_finite``: raises ``FloatingPointError`` naming the tensor.  It
    fetches one flag from the device, so it is a synchronisation point:
    for debugging, not for a step's hot path.
"""

from __future__ import annotations

from typing import Sequence

import torch


def enable_nan_checks(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


def assert_shape(x: torch.Tensor, shape: Sequence[int], name: str = "array"):
    """Shape check; ``None`` entries are wildcards."""
    if len(x.shape) != len(shape) or any(
            s is not None and s != xs for s, xs in zip(shape, x.shape)):
        raise AssertionError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def assert_dtype(x: torch.Tensor, dtype, name: str = "array"):
    if x.dtype != dtype:
        raise AssertionError(f"{name}: expected dtype {dtype}, got {x.dtype}")


def check_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """Raise ``FloatingPointError`` if ``x`` holds a NaN or an infinity;
    returns ``x``."""
    if not bool(torch.isfinite(x.float()).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x
