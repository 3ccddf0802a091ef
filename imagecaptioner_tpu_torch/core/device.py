"""Which device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) needs a card and raises without one; only a caller that
    asks for ``cpu`` gets the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: this entry point runs on the GPU; "
            "pass --device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
