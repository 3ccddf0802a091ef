"""Seeded weights for a configuration, drawn on the device.

A configuration's ``init`` says, by regular expressions over the names of
the program's state dict, which tensors are constants and which are drawn
(``he``: std gain * sqrt(2 / fan_in); ``fan_in``: gain / sqrt(fan_in);
``std``: that std), then scales some (the sharpening that makes greedy rows
differ and END occur), scales single rows (``scale_row``) and adds to
single entries (``add``).  The first rule that
matches a name wins.  All drawn tensors come from one ``torch.randn`` call
on a ``torch.Generator`` of the device, seeded with the run's seed, in the
order of their sorted names; so the same seed, names and device give the
same tensors, and the reference draws them again rather than read the
program's copy.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Sequence, Tuple

import torch


def _fan_in(shape: Sequence[int]) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def draw(shapes: Dict[str, Tuple[int, ...]], init: dict, seed: int,
         device, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for every name of ``shapes``, rounded to ``dtype``
    (the type the program holds them in) and returned in float32."""
    const = [(re.compile(p), float(v)) for p, v in init.get("const", [])]
    normal = [(re.compile(p), kind, float(v))
              for p, kind, v in init.get("normal", [])]
    out: Dict[str, torch.Tensor] = {}
    drawn = []
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        for pat, v in const:
            if pat.search(name):
                out[name] = torch.full(shape, v, device=device)
                break
        else:
            for pat, kind, v in normal:
                if pat.search(name):
                    std = {"he": v * math.sqrt(2.0 / _fan_in(shape)),
                           "fan_in": v / math.sqrt(_fan_in(shape)),
                           "std": v}[kind]
                    drawn.append((name, shape, std))
                    break
            else:
                raise ValueError(f"no init rule for {name}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * std
        at += n
    for pat, factor in init.get("scale", []):
        rx = re.compile(pat)
        for name in out:
            if rx.search(name):
                out[name] = out[name] * float(factor)
    for name, index, factor in init.get("scale_row", []):
        if name in out:
            out[name] = out[name].clone()
            out[name][index] *= float(factor)
    for name, index, value in init.get("add", []):
        if name in out:
            out[name] = out[name].clone()
            out[name][index] += float(value)
    return {k: v.to(dtype).float() for k, v in out.items()}


def load_into(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into ``module``'s parameters and buffers of the same
    names, each in its own dtype; every entry of the state dict must be
    given."""
    state = module.state_dict()
    missing = set(state) - set(tensors)
    if missing:
        raise KeyError(f"no weights for {sorted(missing)[:5]}")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(tensors[name].to(t.dtype))


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
