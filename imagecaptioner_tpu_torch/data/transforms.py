"""Image preprocessing and augmentation on the device
(``imagecaptioner_tpu/data/transforms.py``): uint8 NHWC batches go to the
device as they are; normalization and the stochastic augmentations run
there, drawing from an explicit ``torch.Generator``.

Ported: ``normalize``, ``color_jitter``, ``random_hflip`` and
``augment_and_normalize`` for ``TEACHER_TRAIN_AUG`` and ``KD_TRAIN_AUG``.
Rotation and random crop (``OPTIMIZED_KD_AUG``) belong to the optimized
trainer (ROADMAP Queue 1 item 9) and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class AugmentConfig:
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    hflip_prob: float = 0.0
    rotation_deg: float = 0.0
    random_crop: bool = False
    out_size: int = 224


TEACHER_TRAIN_AUG = AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1,
                                  hue=0.05, hflip_prob=0.3)
KD_TRAIN_AUG = AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2,
                             hue=0.1, hflip_prob=0.5)


def _standardize(x: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """[0, 1] NHWC floats -> normalized NCHW in ``dtype``."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous().to(dtype)


def normalize(images_u8: torch.Tensor, *, dtype=torch.float32,
              mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> normalized float NCHW (the reference model contract)."""
    return _standardize(images_u8.to(torch.float32) / 255.0, mean, std, dtype)


def _uniform(generator, shape, low: float, high: float, device):
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(-1, keepdim=True)


def color_jitter(x: torch.Tensor, cfg: AugmentConfig,
                 generator: Optional[torch.Generator],
                 factors: Optional[dict] = None) -> torch.Tensor:
    """Per-image brightness / contrast / saturation / hue jitter on [0, 1]
    NHWC floats.  Factors are U(max(0, 1-f), 1+f) for b/c/s and U(-hue,
    hue) for hue, drawn from ``generator`` unless ``factors`` gives them
    ready (``brightness``, ``contrast``, ``saturation``: (N, 1, 1, 1);
    ``hue``: (N, 1, 1))."""
    n, dev = x.shape[0], x.device
    factors = factors or {}

    def u(name, f):
        if name in factors:
            return factors[name]
        return _uniform(generator, (n, 1, 1, 1), max(0.0, 1.0 - f), 1.0 + f,
                        dev)

    if cfg.brightness > 0:
        x = (x * u("brightness", cfg.brightness)).clamp(0.0, 1.0)
    if cfg.contrast > 0:
        mean_gray = _rgb_to_gray(x).mean(dim=(1, 2), keepdim=True)
        x = (mean_gray + (x - mean_gray) * u("contrast", cfg.contrast)
             ).clamp(0.0, 1.0)
    if cfg.saturation > 0:
        gray = _rgb_to_gray(x)
        x = (gray + (x - gray) * u("saturation", cfg.saturation)
             ).clamp(0.0, 1.0)
    if cfg.hue > 0:
        # hue rotation in YIQ space, as the JAX package approximates it
        theta = factors["hue"] if "hue" in factors else _uniform(
            generator, (n, 1, 1), -cfg.hue, cfg.hue, dev)
        theta = theta * 2.0 * math.pi
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        i2 = i * cos_t - q * sin_t
        q2 = i * sin_t + q * cos_t
        x = torch.stack([y + 0.956 * i2 + 0.621 * q2,
                         y - 0.272 * i2 - 0.647 * q2,
                         y - 1.106 * i2 + 1.703 * q2], dim=-1).clamp(0.0, 1.0)
    return x


def random_hflip(x: torch.Tensor, prob: float,
                 generator: Optional[torch.Generator],
                 flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flip each NHWC image left-right with probability ``prob`` (or where
    the ready boolean ``flip`` (N,) says)."""
    if flip is None:
        flip = torch.rand(x.shape[0], generator=generator,
                          device=x.device) < prob
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def augment_and_normalize(images_u8: torch.Tensor, cfg: AugmentConfig,
                          generator: Optional[torch.Generator], *,
                          dtype=torch.float32, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD) -> torch.Tensor:
    """The train-time pipeline: uint8 NHWC -> augmented, normalized NCHW."""
    if cfg.rotation_deg > 0 or cfg.random_crop:
        raise NotImplementedError(
            "rotation and random crop are not ported yet (ROADMAP Queue 1 "
            "item 9, the optimized trainer)")
    x = images_u8.to(torch.float32) / 255.0
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        x = color_jitter(x, cfg, generator)
    if cfg.hflip_prob > 0:
        x = random_hflip(x, cfg.hflip_prob, generator)
    return _standardize(x, mean, std, dtype)
