"""Image preprocessing and augmentation on the device
(``imagecaptioner_tpu/data/transforms.py``): uint8 NHWC batches go to the
device as they are; normalization and the stochastic augmentations run
there, drawing from an explicit ``torch.Generator``.

``normalize``, ``random_crop``, ``random_rotation``, ``color_jitter``,
``random_hflip`` and ``augment_and_normalize`` for ``TEACHER_TRAIN_AUG``,
``KD_TRAIN_AUG`` and ``OPTIMIZED_KD_AUG``.  Each random function also takes
its draws ready-made (``offsets=``, ``theta=``, ``factors=``, ``flip=``): the
JAX package draws them from ``jax.random``, which torch cannot reproduce,
so a comparison hands them over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from imagecaptioner_tpu_torch.core.device import device_constant

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
# the optimized trainer's: Resize(out_size + 32) on the host, then
# RandomCrop(out_size) and a rotation of up to 5 degrees on the device
OPTIMIZED_KD_AUG = AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2,
                                 hue=0.1, hflip_prob=0.5, rotation_deg=5.0,
                                 random_crop=True)


def _standardize(x: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """[0, 1] NHWC floats -> normalized NCHW in ``dtype``."""
    m = device_constant(("mean", tuple(mean)), lambda: torch.tensor(
        mean, dtype=torch.float32), x.device)
    s = device_constant(("std", tuple(std)), lambda: torch.tensor(
        std, dtype=torch.float32), x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous().to(dtype)


def normalize(images_u8: torch.Tensor, *, dtype=torch.float32,
              mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> normalized float NCHW (the reference model contract)."""
    return _standardize(images_u8.to(torch.float32) / 255.0, mean, std, dtype)


def _uniform(generator, shape, low: float, high: float, device):
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    w = device_constant(("luma", x.dtype), lambda: torch.tensor(
        [0.299, 0.587, 0.114], dtype=x.dtype), x.device)
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


def random_crop(x: torch.Tensor, out_size: int,
                generator: Optional[torch.Generator],
                offsets: Optional[tuple] = None) -> torch.Tensor:
    """An ``out_size`` square of each NHWC image, at a top-left corner (ty,
    tx) drawn uniformly over the positions that fit (or the ready int
    tensors ``offsets = (ty, tx)``, each (N,))."""
    n, h, w, _ = x.shape
    if offsets is None:
        offsets = tuple(torch.randint(0, size - out_size + 1, (n,),
                                      generator=generator, device=x.device)
                        for size in (h, w))
    ty, tx = (o.to(device=x.device, dtype=torch.long) for o in offsets)
    r = torch.arange(out_size, device=x.device)
    rows = (ty[:, None] + r)[:, :, None]
    cols = (tx[:, None] + r)[:, None, :]
    return x[torch.arange(n, device=x.device)[:, None, None], rows, cols]


def random_rotation(x: torch.Tensor, max_deg: float,
                    generator: Optional[torch.Generator],
                    theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate each NHWC image about its centre by an angle drawn from
    U(-max_deg, max_deg) degrees (or the ready ``theta`` (N,), in degrees):
    bilinear resampling with the four corners clipped to the image, and
    0 wherever the source point falls outside it."""
    n, h, w, c = x.shape
    if theta is None:
        theta = _uniform(generator, (n,), -max_deg, max_deg, x.device)
    theta = theta.to(device=x.device, dtype=torch.float32) * math.pi / 180.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=x.device) - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    src_y = cos_t * yy - sin_t * xx + cy
    src_x = sin_t * yy + cos_t * xx + cx
    y0 = torch.clamp(torch.floor(src_y), 0, h - 1)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    flat = x.reshape(n, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).long().reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    valid = (src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1)
    return torch.where(valid[..., None], out, torch.zeros((), device=x.device))


def augment_and_normalize(images_u8: torch.Tensor, cfg: AugmentConfig,
                          generator: Optional[torch.Generator], *,
                          dtype=torch.float32, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD,
                          draws: Optional[dict] = None) -> torch.Tensor:
    """The train-time pipeline: uint8 NHWC -> augmented, normalized NCHW:
    the random crop (only when the images are larger than ``out_size``),
    the rotation, the colour jitter, the flip.  ``draws`` may hand any of
    them its values: ``offsets``, ``theta``, ``factors``, ``flip``."""
    draws = draws or {}
    x = images_u8.to(torch.float32) / 255.0
    if cfg.random_crop and x.shape[1] > cfg.out_size:
        x = random_crop(x, cfg.out_size, generator, draws.get("offsets"))
    if cfg.rotation_deg > 0:
        x = random_rotation(x, cfg.rotation_deg, generator, draws.get("theta"))
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        x = color_jitter(x, cfg, generator, draws.get("factors"))
    if cfg.hflip_prob > 0:
        x = random_hflip(x, cfg.hflip_prob, generator, draws.get("flip"))
    return _standardize(x, mean, std, dtype)
