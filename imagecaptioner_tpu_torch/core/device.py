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


_CONSTANTS: dict = {}


def device_constant(key, make, device) -> torch.Tensor:
    """A constant tensor on ``device``, uploaded once per ``(key,
    device)``: ``make()`` builds it on the host at the first call.  Steps
    that ask for the same table every call (normalization statistics,
    pooling matrices) then copy nothing from the host, so a chained KD
    step moves only its row indices (``train/steps.make_device_data_step``).
    Callers must not write into it."""
    dev = torch.device(device)
    k = (key, dev)
    if k not in _CONSTANTS:
        # a plain tensor even when first asked for under inference_mode, so
        # that autograd may save it later
        with torch.inference_mode(False):
            _CONSTANTS[k] = make().to(dev)
    return _CONSTANTS[k]
