"""Precision policy of the port (``imagecaptioner_tpu/core/precision.py``).

Parameters and optimizer state stay float32.  The compute dtype is the dtype
of the activations: a step casts its images to it, and every ``dense`` /
``conv2d`` casts its float32 weight to the activation dtype at use, so
autograd hands the gradient back in float32.  Matmuls accumulate in float32;
layer norm, batch-norm statistics, softmax and the losses run in float32.
bfloat16 has float32's exponent range, so there is no loss scaling.  The
frozen teacher computes in float32 unless ``KDTrainConfig.teacher_bf16``.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name; only the policy's two."""
    dt = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in DTYPES.values():
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return dt
