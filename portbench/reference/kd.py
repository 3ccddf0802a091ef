"""The KD train step in plain float32 PyTorch: the colour jitter and flip,
the frozen teacher (eval mode), the full student in train mode (batch
statistics, dropout), the feature projector, the distillation loss
(token KD at temperature 4 over the valid steps, the feature loss, a
cross-entropy weighted by 1 - alpha - beta - gamma), the mean over the
micro-batches, the global-norm clip and AdamW in three rate groups.

The random draws of a step (the jitter factors, the flips, the dropout
masks) are handed in, as ``Draws``: they are what the program's generator
drew, the one input of the step that a reference cannot draw again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import student as S
from portbench.reference import teacher as TR
from portbench.reference.precision import Rounding, f32

FROZEN = ("encoder.resnet.conv1.", "encoder.resnet.bn1.",
          "encoder.resnet.layer1.", "encoder.resnet.layer2.")
BUFFERS = ("running_mean", "running_var")


class Draws:
    """One micro-batch's draws: ``uniform`` (the jitter's brightness,
    contrast, saturation and hue factors, in that order), ``flip`` (N,),
    and ``masks``, the boolean keep masks in the order they were drawn,
    taken by shape."""

    def __init__(self, uniform: List[torch.Tensor], flip: torch.Tensor,
                 masks: List[torch.Tensor]):
        self.uniform, self.flip, self.masks = uniform, flip, list(masks)

    def drop(self, shape: tuple, rate: float) -> torch.Tensor:
        for i, m in enumerate(self.masks):
            if tuple(m.shape) == tuple(shape):
                return self.masks.pop(i).float() / (1.0 - rate)
        raise KeyError(f"no recorded dropout mask of shape {shape}")


def augment(images_u8: torch.Tensor, d: Draws) -> torch.Tensor:
    """KD_TRAIN_AUG's colour jitter (brightness, contrast, saturation, a
    hue rotation in YIQ) and flip, then the normalization: -> NCHW."""
    x = images_u8.float() / 255.0
    fb, fc, fs, hue = d.uniform
    luma = torch.tensor([0.299, 0.587, 0.114], device=x.device)
    x = (x * fb).clamp(0.0, 1.0)
    mean_gray = (x * luma).sum(-1, keepdim=True).mean(dim=(1, 2), keepdim=True)
    x = (mean_gray + (x - mean_gray) * fc).clamp(0.0, 1.0)
    gray = (x * luma).sum(-1, keepdim=True)
    x = (gray + (x - gray) * fs).clamp(0.0, 1.0)
    theta = hue * 2.0 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    i2, q2 = i * c - q * s, i * s + q * c
    x = torch.stack([y + 0.956 * i2 + 0.621 * q2, y - 0.272 * i2 - 0.647 * q2,
                     y - 1.106 * i2 + 1.703 * q2], -1).clamp(0.0, 1.0)
    x = torch.where(d.flip[:, None, None, None], x.flip(2), x)
    m = torch.tensor(S.MEAN, device=x.device)
    sd = torch.tensor(S.STD, device=x.device)
    return ((x - m) / sd).permute(0, 3, 1, 2).contiguous()


def projector(memory, W, d: Draws, r: Rounding, tokens: int):
    """The teacher's features to the student's width (Linear, ReLU,
    dropout 0.1, LayerNorm, where the widths differ) and its tokens
    (adaptive average pool)."""
    x = memory
    p = "projectors.encoder.feature_projection."
    if p + "fc.weight" in W:
        x = F.relu(S.linear(x, W, p + "fc", r))
        x = S.layer_norm(x * d.drop(tuple(x.shape), 0.1), W, p + "ln")
    return F.adaptive_avg_pool1d(x.transpose(1, 2), tokens).transpose(1, 2)


def distillation_loss(s_logits, t_logits, s_feats, t_feats, targets,
                      lengths, alpha=0.7, beta=0.2, gamma=0.1, temp=4.0):
    """logits (T, B, V), features (B, L, E), targets (T, B)."""
    T, B, _ = s_logits.shape
    logp = torch.log_softmax(s_logits, -1)
    nll = -logp.gather(-1, targets[..., None]).squeeze(-1)
    keep = (targets != S.PAD).float()
    ce = (nll * keep).sum() / keep.sum().clamp(min=1.0)
    s = torch.log_softmax(s_logits / temp, -1)
    t = torch.softmax(t_logits / temp, -1)
    log_t = torch.where(t > 0, torch.log(t.clamp(min=1e-38)),
                        torch.zeros_like(t))
    kl = (t * (log_t - s)).sum(-1)
    valid = (lengths.max() - 1).clamp(min=1).float()
    steps = torch.arange(T, device=kl.device, dtype=torch.float32)[:, None]
    token_kd = (kl * (steps < valid).float()).sum() / (valid * B) * temp ** 2
    sf, tf = s_feats, t_feats
    glob = (sf.mean(1) - tf.mean(1)).square().mean()
    sw = (sf * torch.softmax(sf.sum(-1), 1)[..., None]).sum(1)
    tw = (tf * torch.softmax(tf.sum(-1), 1)[..., None]).sum(1)
    feature_kd = 0.6 * glob + 0.4 * (sw - tw).square().mean()
    return ((1.0 - alpha - beta - gamma) * ce + alpha * token_kd
            + beta * feature_kd)


def cosine_warm_restarts(t: float, base_lr: float, t0: int = 5,
                         t_mult: int = 2, eta_min: float = 1e-6) -> float:
    n = math.floor(math.log(t / t0 * (t_mult - 1.0) + 1.0) / math.log(t_mult))
    t_cur = t - t0 * (t_mult ** n - 1.0) / (t_mult - 1.0)
    t_i = t0 * float(t_mult) ** n
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0


class KDReference:
    """The student (``student.*``), the projectors (``projectors.*``) and
    AdamW's moments, stepped as the port's KD step steps them."""

    def __init__(self, W_student: Dict[str, torch.Tensor],
                 W_projectors: Dict[str, torch.Tensor],
                 W_teacher: Dict[str, torch.Tensor], teacher_cfg: dict,
                 tokens: int, *, lr: float = 2e-4, encoder_scale: float = 0.1,
                 weight_decay: float = 0.01, clip: float = 1.0,
                 dropout: float = 0.3, r_student: Rounding = f32,
                 r_teacher: Rounding = f32):
        self.P = {f"student.{k}": v.clone() for k, v in W_student.items()}
        self.P.update({f"projectors.{k}": v.clone()
                       for k, v in W_projectors.items()})
        self.trainable = [n for n in self.P
                          if not n.endswith(BUFFERS)
                          and not n[len("student."):].startswith(FROZEN)]
        for n in self.trainable:
            self.P[n].requires_grad_(True)
        self.Wt, self.tcfg, self.tokens = W_teacher, teacher_cfg, tokens
        self.lr, self.enc, self.wd, self.clip = lr, encoder_scale, \
            weight_decay, clip
        self.rate, self.rs, self.rt = dropout, r_student, r_teacher
        self.mu = {n: torch.zeros_like(self.P[n]) for n in self.trainable}
        self.nu = {n: torch.zeros_like(self.P[n]) for n in self.trainable}
        self.count = 0

    def student_W(self) -> Dict[str, torch.Tensor]:
        return {k[len("student."):]: v for k, v in self.P.items()
                if k.startswith("student.")}

    def micro_loss(self, images_u8, captions, lengths, d: Draws):
        x = augment(images_u8, d)
        with torch.no_grad():
            memory = TR.encode_image(x, self.Wt, self.tcfg, self.rt)
            t_logits = TR.decode(memory, captions[:-1].t(), self.Wt,
                                 self.tcfg["num_heads"], self.rt)
        Ws = self.student_W()
        raw, refined = S.encode(x, Ws, self.rs, train=True, drop=d.drop)
        s_logits, _ = S.decode(refined, captions[:-1].t(), Ws, self.rs,
                               drop=d.drop, rate=self.rate)
        proj = projector(memory, self.P, d, self.rs, self.tokens)
        return distillation_loss(s_logits.transpose(0, 1),
                                 t_logits.transpose(0, 1), raw, proj,
                                 captions[1:], lengths)

    def step(self, batch: Dict[str, torch.Tensor], draws: List[Draws],
             sched_t: float) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One optimizer step over the stacked batch (images (A, B, S, S,
        3) uint8, captions (A, T, B), lengths (A, B)); returns the mean
        loss and the gradients as AdamW took them."""
        A = batch["images"].shape[0]
        params = [self.P[n] for n in self.trainable]
        total = 0.0
        grads = [torch.zeros_like(p) for p in params]
        for a in range(A):
            loss = self.micro_loss(batch["images"][a], batch["captions"][a],
                                   batch["lengths"][a], draws[a])
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            for g, gi in zip(grads, gs):
                if gi is not None:
                    g += gi
            total += float(loss.detach())
        with torch.no_grad():
            grads = [g / A for g in grads]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-6),
                                max=1.0)
            grads = [g * scale for g in grads]
            self.count += 1
            bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
            for n, p, g in zip(self.trainable, params, grads):
                s = self.enc if n.startswith("student.encoder.") else 1.0
                lr = cosine_warm_restarts(sched_t, self.lr * s)
                self.mu[n].mul_(0.9).add_(g, alpha=0.1)
                self.nu[n].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (self.nu[n] / bc2).sqrt() + 1e-8
                p.mul_(1.0 - lr * self.wd)
                p.addcdiv_(self.mu[n], denom, value=-lr / bc1)
        return total / A, dict(zip(self.trainable, grads))
