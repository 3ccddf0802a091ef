"""Headless ResNet-50 in eval mode (``imagecaptioner_tpu/models/resnet.py``).

Submodule names follow the JAX parameter tree (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1..3}/bn{1..3}``, ``downsample.conv/bn``), so the
converted tree loads with ``strict=True``.  NCHW at the surface; the
activations run channels-last inside, which only changes the memory layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioner_tpu_torch.core.modules import (BatchNorm2d, Conv2d,
                                                   batch_norm_init, conv2d_init,
                                                   max_pool2d)

# (blocks, mid_channels, stride) per stage; out = mid * 4
STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
OUT_CHANNELS = 2048


class Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1, stride=stride)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(in_ch, mid, 1)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = Conv2d(mid, mid * 4, 1)
        self.bn3 = BatchNorm2d(mid * 4)
        self.downsample = (Downsample(in_ch, mid * 4, stride) if downsample
                           else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for li, (blocks, mid, stride) in enumerate(STAGES, start=1):
            layer = nn.ModuleList()
            for bi in range(blocks):
                st = stride if bi == 0 else 1
                ds = bi == 0 and (st != 1 or in_ch != mid * 4)
                layer.append(Bottleneck(in_ch, mid, st, ds))
                in_ch = mid * 4
            setattr(self, f"layer{li}", layer)

    @staticmethod
    def init(rng: np.random.Generator):
        """Random (params, state) trees in the layout of
        ``resnet.resnet50_init``."""
        p = {"conv1": conv2d_init(rng, 3, 64, 7)}
        s = {}
        p["bn1"], s["bn1"] = batch_norm_init(64)
        in_ch = 64
        for li, (blocks, mid, stride) in enumerate(STAGES, start=1):
            p[f"layer{li}"], s[f"layer{li}"] = [], []
            for bi in range(blocks):
                st = stride if bi == 0 else 1
                bp = {"conv1": conv2d_init(rng, in_ch, mid, 1),
                      "conv2": conv2d_init(rng, mid, mid, 3),
                      "conv3": conv2d_init(rng, mid, mid * 4, 1)}
                bs = {}
                for i, ch in (("1", mid), ("2", mid), ("3", mid * 4)):
                    bp[f"bn{i}"], bs[f"bn{i}"] = batch_norm_init(ch)
                if bi == 0 and (st != 1 or in_ch != mid * 4):
                    bp["downsample"] = {
                        "conv": conv2d_init(rng, in_ch, mid * 4, 1)}
                    bp["downsample"]["bn"], bs["downsample_bn"] = \
                        batch_norm_init(mid * 4)
                p[f"layer{li}"].append(bp)
                s[f"layer{li}"].append(bs)
                in_ch = mid * 4
        return p, s

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 2048, H/32, W/32)."""
        x = x_nchw.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool2d(x, 3, 2, 1)
        for li in range(1, len(STAGES) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
        return x
