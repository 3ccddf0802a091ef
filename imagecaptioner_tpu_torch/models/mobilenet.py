"""MobileNetV2 feature extractor, the compact student's backbone
(``imagecaptioner_tpu/models/mobilenet.py``).

Submodule names follow the JAX parameter tree: ``features.0`` is the stem
ConvBNReLU6, ``features.1..17`` the inverted residuals (``expand`` /
``depthwise`` / ``project``, each ``conv`` + ``bn``), ``features.18`` the head,
so the converted tree loads with ``strict=True`` and "freeze the first ten
feature layers" is a prefix of the names.  NCHW at the surface; 1280 output
channels.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.modules import (BatchNorm2d, Conv2d,
                                                   batch_norm_init,
                                                   conv2d_init, relu6)

# torchvision inverted_residual_setting: (expand t, out c, repeats n, stride s)
IR_SETTING = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
STEM_CHANNELS = 32
OUT_CHANNELS = 1280
FREEZE_FIRST = 10  # feature layers the reference freezes


def block_meta() -> List[Tuple[int, int, int, int]]:
    """Per inverted residual: (in_ch, out_ch, expansion, stride)."""
    meta, in_ch = [], STEM_CHANNELS
    for t, c, n, s in IR_SETTING:
        for bi in range(n):
            meta.append((in_ch, c, t, s if bi == 0 else 1))
            in_ch = c
    return meta


class ConvBN(nn.Module):
    """conv (no bias) + batch norm + an optional activation."""

    def __init__(self, in_ch: int, out_ch: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, act=relu6):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, k, stride=stride, padding=padding,
                           groups=groups)
        self.bn = BatchNorm2d(out_ch)
        self.act = act

    @staticmethod
    def init(rng: np.random.Generator, in_ch: int, out_ch: int, k: int,
             groups: int = 1):
        p = {"conv": conv2d_init(rng, in_ch, out_ch, k, groups=groups)}
        p["bn"], s = batch_norm_init(out_ch)
        return p, s

    def forward(self, x):
        y = self.bn(self.conv(x))
        return y if self.act is None else self.act(y)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, t: int, stride: int):
        super().__init__()
        hidden = in_ch * t
        if t != 1:
            self.expand = ConvBN(in_ch, hidden, 1)
        self.depthwise = ConvBN(hidden, hidden, 3, stride=stride, padding=1,
                                groups=hidden)
        self.project = ConvBN(hidden, out_ch, 1, act=None)
        self.use_res = stride == 1 and in_ch == out_ch

    @staticmethod
    def init(rng: np.random.Generator, in_ch: int, out_ch: int, t: int):
        hidden = in_ch * t
        p: Dict = {}
        s: Dict = {}
        if t != 1:
            p["expand"], s["expand"] = ConvBN.init(rng, in_ch, hidden, 1)
        p["depthwise"], s["depthwise"] = ConvBN.init(rng, hidden, hidden, 3,
                                                     groups=hidden)
        p["project"], s["project"] = ConvBN.init(rng, hidden, out_ch, 1)
        return p, s

    def forward(self, x):
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.depthwise(y))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        meta = block_meta()
        self.features = nn.ModuleList(
            [ConvBN(3, STEM_CHANNELS, 3, stride=2, padding=1)]
            + [InvertedResidual(*m) for m in meta]
            + [ConvBN(meta[-1][1], OUT_CHANNELS, 1)])

    @staticmethod
    def init(rng: np.random.Generator):
        """Random (params, state) trees in the layout of
        ``mobilenet.mobilenet_v2_init``."""
        meta = block_meta()
        pairs = [ConvBN.init(rng, 3, STEM_CHANNELS, 3)]
        pairs += [InvertedResidual.init(rng, i, o, t) for i, o, t, _ in meta]
        pairs.append(ConvBN.init(rng, meta[-1][1], OUT_CHANNELS, 1))
        return ({"features": [p for p, _ in pairs]},
                {"features": [s for _, s in pairs]})

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1280, H/32, W/32)."""
        x = x_nchw.contiguous(memory_format=torch.channels_last)
        for layer in self.features:
            x = layer(x)
        return x


def frozen_prefixes(freeze_first: int = FREEZE_FIRST) -> Tuple[str, ...]:
    """Name prefixes (inside the backbone) of ``features[0..freeze_first)``,
    as ``mobilenet_v2_trainable_mask``."""
    return tuple(f"features.{i}." for i in range(freeze_first))
