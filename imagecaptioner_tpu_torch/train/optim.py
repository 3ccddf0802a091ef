"""Optimizer and LR schedule (``imagecaptioner_tpu/train/optim.py``).

AdamW with torch semantics (decoupled decay first, then the Adam step) over
named parameters, with a per-parameter lr scale, weight decay and trainable
mask: the generalisation of torch param groups that the JAX package uses.
A frozen parameter keeps its value and its zero moments.  Plus
``clip_by_global_norm``, the two schedules (``cosine_warm_restarts`` for the
teacher and KD trainers, ``onecycle_lr`` for the optimized one) and the
teacher's ``label_smoothing_loss``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch


@dataclass
class AdamWState:
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    return AdamWState(step=0,
                      mu={k: torch.zeros_like(p) for k, p in params.items()},
                      nu={k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], *,
                 lr_fn: Callable[[float], float], lr_scale: Dict[str, float],
                 weight_decay: Union[float, Dict[str, float]] = 0.01,
                 trainable: Dict[str, bool], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW step in place on ``params`` and ``state``.  A parameter's
    learning rate is ``lr_fn(lr_scale[name])`` and its weight decay
    ``weight_decay``, or ``weight_decay[name]`` when it is a dict;
    parameters that share both are updated together."""
    state.step += 1
    bc1 = 1.0 - b1 ** state.step
    bc2 = 1.0 - b2 ** state.step
    groups = defaultdict(list)
    for name in params:
        if trainable[name]:
            wd = (weight_decay[name] if isinstance(weight_decay, dict)
                  else weight_decay)
            groups[lr_scale[name], wd].append(name)
    for (scale, wd), names in groups.items():
        lr = lr_fn(scale)
        P = [params[n] for n in names]
        G = [grads[n] for n in names]
        M = [state.mu[n] for n in names]
        V = [state.nu[n] for n in names]
        torch._foreach_mul_(M, b1)
        torch._foreach_add_(M, G, alpha=1.0 - b1)
        torch._foreach_mul_(V, b2)
        torch._foreach_addcmul_(V, G, G, value=1.0 - b2)
        # p <- p * (1 - lr*wd) - lr * (m / bc1) / (sqrt(v / bc2) + eps)
        denom = torch._foreach_div(V, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_mul_(P, 1.0 - lr * wd)
        torch._foreach_addcdiv_(P, M, denom, value=-lr / bc1)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """``clip_grad_norm_`` semantics, in place; returns the norm before
    clipping."""
    gs = list(grads.values())
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in gs])))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    torch._foreach_mul_(gs, scale)
    return norm


def cosine_warm_restarts(t: float, *, base_lr: float, t0: int = 5,
                         t_mult: int = 2, eta_min: float = 1e-6) -> float:
    """torch CosineAnnealingWarmRestarts at continuous epoch time ``t`` (the
    trainers step it fractionally per batch)."""
    t = float(t)
    if t_mult == 1:
        t_cur, t_i = math.fmod(t, t0), float(t0)
    else:
        n = math.floor(math.log(t / t0 * (t_mult - 1.0) + 1.0)
                       / math.log(t_mult))
        t_cur = t - t0 * (t_mult ** n - 1.0) / (t_mult - 1.0)
        t_i = t0 * float(t_mult) ** n
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0


def onecycle_lr(step: float, *, max_lr: float, total_steps: int,
                pct_start: float = 0.1, div_factor: float = 10.0,
                final_div_factor: float = 100.0) -> float:
    """torch OneCycleLR (cosine annealing) at optimizer step ``step``: from
    ``max_lr / div_factor`` up to ``max_lr`` over ``pct_start * total_steps
    - 1`` steps, then down to ``max_lr / div_factor / final_div_factor`` at
    step ``total_steps - 1``."""
    step = float(step)
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = pct_start * total_steps - 1.0
    down_steps = (total_steps - 1.0) - up_steps

    def cos_anneal(start: float, end: float, pct: float) -> float:
        return end + (start - end) * (1.0 + math.cos(math.pi * pct)) / 2.0

    if step <= up_steps:
        pct = min(max(step / max(up_steps, 1.0), 0.0), 1.0)
        return cos_anneal(initial, max_lr, pct)
    pct = min(max((step - up_steps) / max(down_steps, 1.0), 0.0), 1.0)
    return cos_anneal(max_lr, final, pct)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                         num_classes: int, smoothing: float = 0.1,
                         ignore_index: int = 0,
                         lengths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The teacher trainer's loss: smoothing / (V - 1) on every class,
    ``1 - smoothing`` on the target, the PAD column zeroed and PAD-target
    rows zeroed, with the reference's denominator: every row counts, PAD
    rows included.  With ``lengths`` (B,) the rows at or past
    ``max(lengths) - 1`` are cut from the sum and from the count, which
    undoes the static padding.  logits (T, B, V), targets (T, B) -> a
    0-d float32 tensor."""
    T, B, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_dist = torch.full_like(logp, smoothing / (num_classes - 1))
    true_dist.scatter_(-1, targets[..., None], 1.0 - smoothing)
    true_dist[..., ignore_index] = 0.0
    row_valid = (targets != ignore_index).float()
    loss_rows = -(true_dist * logp).sum(-1) * row_valid
    if lengths is None:
        return loss_rows.sum() / float(T * B)
    valid_steps = torch.clamp(lengths.max() - 1, min=1).float()
    steps = torch.arange(T, device=logits.device, dtype=torch.float32)
    in_range = (steps[:, None] < valid_steps).float()
    return (loss_rows * in_range).sum() / (valid_steps * B)
