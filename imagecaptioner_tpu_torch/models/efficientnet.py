"""EfficientNet-B3 feature extractor, the enhanced student's backbone
(``imagecaptioner_tpu/models/efficientnet.py``).

torchvision ``efficientnet_b3(...).features`` semantics: width 1.2 and depth
1.4 over the B0 stages, MBConv blocks with squeeze-excitation and SiLU, no
stochastic depth, 1536 output channels.  Submodule names follow the JAX
parameter tree (``stem``, ``stages.{i}.{j}.expand/depthwise/se/project``,
``head``), so the converted tree loads with ``strict=True``.  NCHW at the
surface.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.modules import Conv2d, conv2d_init, silu
from imagecaptioner_tpu_torch.models.mobilenet import ConvBN

OUT_CHANNELS = 1536
FREEZE_STAGES = 4  # the stem and this many stages are frozen


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def b3_stages() -> List[Tuple[int, int, int, int, int, int]]:
    """(expand_t, in_ch, out_ch, num_blocks, stride, kernel) per stage."""
    base = [  # B0: t, c, n, s, k
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3),
    ]
    width, depth = 1.2, 1.4
    stages = []
    in_ch = _make_divisible(32 * width)  # stem = 40
    for t, c, n, s, k in base:
        out_ch = _make_divisible(c * width)
        stages.append((t, in_ch, out_ch, int(math.ceil(n * depth)), s, k))
        in_ch = out_ch
    return stages


STAGES = b3_stages()
STEM_CH = _make_divisible(32 * 1.2)


def _conv_bn(in_ch, out_ch, k, **kw) -> ConvBN:
    return ConvBN(in_ch, out_ch, k, act=kw.pop("act", silu), **kw)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = Conv2d(channels, squeeze, 1, bias=True)
        self.fc2 = Conv2d(squeeze, channels, 1, bias=True)

    def forward(self, y):
        se = y.float().mean(dim=(2, 3), keepdim=True).to(y.dtype)
        return y * torch.sigmoid(self.fc2(silu(self.fc1(se))))


class MBConv(nn.Module):
    def __init__(self, t: int, in_ch: int, out_ch: int, k: int, stride: int):
        super().__init__()
        hidden = in_ch * t
        if t != 1:
            self.expand = _conv_bn(in_ch, hidden, 1)
        self.depthwise = _conv_bn(hidden, hidden, k, stride=stride,
                                  padding=k // 2, groups=hidden)
        # torchvision: the squeeze width comes from the block's INPUT channels
        self.se = SqueezeExcite(hidden, max(1, in_ch // 4))
        self.project = _conv_bn(hidden, out_ch, 1, act=None)
        self.use_res = stride == 1 and in_ch == out_ch

    @staticmethod
    def init(rng: np.random.Generator, t: int, in_ch: int, out_ch: int, k: int):
        hidden, sq = in_ch * t, max(1, in_ch // 4)
        p: Dict = {}
        s: Dict = {}
        if t != 1:
            p["expand"], s["expand"] = ConvBN.init(rng, in_ch, hidden, 1)
        p["depthwise"], s["depthwise"] = ConvBN.init(rng, hidden, hidden, k,
                                                     groups=hidden)
        p["se"] = {"fc1": conv2d_init(rng, hidden, sq, 1, bias=True),
                   "fc2": conv2d_init(rng, sq, hidden, 1, bias=True)}
        p["project"], s["project"] = ConvBN.init(rng, hidden, out_ch, 1)
        return p, s

    def forward(self, x):
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.se(self.depthwise(y)))
        return x + y if self.use_res else y


def _blocks():
    """Per stage, per block: (t, in_ch, out_ch, kernel, stride)."""
    for t, in_ch, out_ch, blocks, stride, k in STAGES:
        yield [(t, in_ch if b == 0 else out_ch, out_ch, k,
                stride if b == 0 else 1) for b in range(blocks)]


class EfficientNetB3(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _conv_bn(3, STEM_CH, 3, stride=2, padding=1)
        self.stages = nn.ModuleList(
            nn.ModuleList(MBConv(*b) for b in stage) for stage in _blocks())
        self.head = _conv_bn(STAGES[-1][2], OUT_CHANNELS, 1)

    @staticmethod
    def init(rng: np.random.Generator):
        """Random (params, state) trees in the layout of
        ``efficientnet.efficientnet_b3_init``."""
        p: Dict = {}
        s: Dict = {}
        p["stem"], s["stem"] = ConvBN.init(rng, 3, STEM_CH, 3)
        p["stages"], s["stages"] = [], []
        for stage in _blocks():
            pairs = [MBConv.init(rng, t, i, o, k) for t, i, o, k, _ in stage]
            p["stages"].append([bp for bp, _ in pairs])
            s["stages"].append([bs for _, bs in pairs])
        p["head"], s["head"] = ConvBN.init(rng, STAGES[-1][2], OUT_CHANNELS, 1)
        return p, s

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1536, H/32, W/32)."""
        x = self.stem(x_nchw.contiguous(memory_format=torch.channels_last))
        for stage in self.stages:
            for block in stage:
                x = block(x)
        return self.head(x)


def frozen_prefixes(freeze_stages: int = FREEZE_STAGES) -> Tuple[str, ...]:
    """Name prefixes (inside the backbone) of the stem and the first
    ``freeze_stages`` stages, as ``efficientnet_b3_trainable_mask``."""
    return ("stem.",) + tuple(f"stages.{i}." for i in range(freeze_stages))
