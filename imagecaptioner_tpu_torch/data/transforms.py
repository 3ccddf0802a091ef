"""Serving-time image preprocessing (``imagecaptioner_tpu.data.transforms``)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor, *, dtype=torch.float32,
              mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> normalized float NCHW (the reference model contract)."""
    x = images_u8.to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous().to(dtype)
