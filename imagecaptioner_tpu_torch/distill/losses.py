"""Distillation losses (``imagecaptioner_tpu/distill/losses.py:26-198``).

Captions are padded to a fixed T, while the reference computes its losses
over the batch's own maximum length.  Every normalizer therefore masks to
``valid_steps = max(lengths) - 1`` so loss values match the reference:

  * KL ``batchmean`` divides by valid_steps * B: in-range PAD rows count in
    the normalizer, a reference quirk, preserved.
  * CE ignores PAD targets: mean over non-PAD targets only.
  * With the default weights the CE coefficient (1-a-b-g) is exactly 0:
    preserved, not fixed.

The optimized trainer's ``optimized_distillation_loss`` weighs its terms
by a warmup over epochs (at epoch 0 only the token loss counts), takes a
soft-CE token KD and a ``focal_loss`` hard term, both over the step mask
and not ignoring PAD, and a cosine feature loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                  OptimizedDistillConfig)


LOSS_NAMES = ("total_loss", "ce_loss", "token_kd_loss", "feature_kd_loss",
              "hidden_kd_loss")
# the optimized trainer's history and log (``ce_loss`` equals ``hard_loss``)
OPTIMIZED_LOSS_NAMES = ("total_loss", "token_kd_loss", "feature_kd_loss",
                        "hidden_kd_loss", "kd_loss", "hard_loss")


def _step_mask(T: int, B: int, lengths: Optional[torch.Tensor], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, B) float mask of steps < valid_steps, and valid_steps."""
    if lengths is None:
        return (torch.ones(T, B, device=device),
                torch.tensor(float(T), device=device))
    valid_steps = torch.clamp(lengths.max() - 1, min=1).float()
    steps = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    return (steps < valid_steps).float().expand(T, B), valid_steps


def cross_entropy_ignore_pad(logits: torch.Tensor, targets: torch.Tensor
                             ) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=0) over (T, B, V) logits and (T, B)
    targets: mean over non-PAD positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None]).squeeze(-1)
    mask = (targets != 0).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_level_distillation(student_logits: torch.Tensor,
                             teacher_logits: torch.Tensor, temperature: float,
                             lengths: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """KL(log_softmax(s/T) || softmax(t/T)) * T^2, batchmean."""
    T, B, _ = student_logits.shape
    s = torch.log_softmax(student_logits.float() / temperature, -1)
    t = torch.softmax(teacher_logits.float() / temperature, -1)
    log_t = torch.where(t > 0, torch.log(torch.clamp(t, min=1e-38)),
                        torch.zeros_like(t))
    kl = (t * (log_t - s)).sum(-1)                                  # (T, B)
    mask, valid_steps = _step_mask(T, B, lengths, kl.device)
    return (kl * mask).sum() / (valid_steps * B) * (temperature ** 2)


def encoder_feature_distillation(student_features: torch.Tensor,
                                 teacher_features: torch.Tensor
                                 ) -> torch.Tensor:
    """0.6 * MSE(global mean) + 0.4 * MSE(attention-weighted), where the
    attention weights are a softmax over per-token feature sums."""
    sf, tf = student_features.float(), teacher_features.float()
    global_loss = (sf.mean(1) - tf.mean(1)).square().mean()
    s_attn = torch.softmax(sf.sum(-1), dim=1)
    t_attn = torch.softmax(tf.sum(-1), dim=1)
    s_w = (sf * s_attn[..., None]).sum(1)
    t_w = (tf * t_attn[..., None]).sum(1)
    return 0.6 * global_loss + 0.4 * (s_w - t_w).square().mean()


def decoder_hidden_state_distillation(student_hiddens: Optional[torch.Tensor],
                                      teacher_hiddens: Optional[torch.Tensor]
                                      ) -> torch.Tensor:
    """Per-step 0.7*MSE + 0.3*(1-cos), mean over steps.  Zero when either
    side is None, which is every real run: the teacher wrapper yields
    ``hidden_states=None``."""
    if student_hiddens is None or teacher_hiddens is None:
        dev = (student_hiddens if student_hiddens is not None
               else teacher_hiddens)
        return torch.zeros((), device=None if dev is None else dev.device)
    T = min(student_hiddens.shape[0], teacher_hiddens.shape[0])
    s, t = student_hiddens[:T].float(), teacher_hiddens[:T].float()
    mse = (s - t).square().mean(dim=(1, 2))
    cos = (s * t).sum(-1) / torch.clamp(s.norm(dim=-1) * t.norm(dim=-1),
                                        min=1e-8)
    return (0.7 * mse + 0.3 * (1.0 - cos).mean(dim=1)).mean()


def distillation_loss(student_outputs: Dict, teacher_outputs: Dict,
                      targets: torch.Tensor, cfg: DistillConfig,
                      lengths: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DistillationLoss.forward: the weighted total and its four terms."""
    ce = cross_entropy_ignore_pad(student_outputs["logits"], targets)
    token_kd = token_level_distillation(
        student_outputs["logits"], teacher_outputs["logits"], cfg.temperature,
        lengths)
    feature_kd = torch.zeros((), device=ce.device)
    if ("encoder_features" in student_outputs
            and "encoder_features" in teacher_outputs):
        feature_kd = encoder_feature_distillation(
            student_outputs["encoder_features"],
            teacher_outputs["encoder_features"])
    hidden_kd = decoder_hidden_state_distillation(
        student_outputs.get("hidden_states"),
        teacher_outputs.get("hidden_states")).to(ce.device)
    total = ((1.0 - cfg.alpha - cfg.beta - cfg.gamma) * ce
             + cfg.alpha * token_kd + cfg.beta * feature_kd
             + cfg.gamma * hidden_kd)
    return total, {"total_loss": total, "ce_loss": ce,
                   "token_kd_loss": token_kd, "feature_kd_loss": feature_kd,
                   "hidden_kd_loss": hidden_kd}


# ---------------------------------------------------------------------------
# The optimized trainer's loss
# ---------------------------------------------------------------------------


def focal_loss(logits_flat: torch.Tensor, targets_flat: torch.Tensor,
               alpha: float, gamma: float,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha * (1 - pt)^gamma * CE per row, averaged over the rows of
    ``mask`` (all rows without it).  PAD targets count: the reference's
    cross-entropy here has no ignore index."""
    logp = torch.log_softmax(logits_flat.float(), dim=-1)
    ce = -logp.gather(-1, targets_flat[:, None]).squeeze(-1)
    pt = torch.exp(-ce)
    fl = alpha * (1.0 - pt) ** gamma * ce
    if mask is None:
        return fl.mean()
    return (fl * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def optimized_distillation_loss(
        student_outputs: Dict, teacher_outputs: Dict, targets: torch.Tensor,
        cfg: OptimizedDistillConfig, epoch: int,
        lengths: Optional[torch.Tensor] = None,
        hidden_noise: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total and its terms.  The warmup ``min(1, epoch /
    warmup_epochs)`` moves alpha from 0.9 to ``cfg.alpha`` and beta and
    gamma from 0 to theirs.  The hidden-state term weighs each step by a
    softmax over time of ``hidden_noise`` (T, B), the reference's random
    weights, which the caller draws; without it, or without the teacher's
    hidden states (every real run), the term is 0."""
    warmup = min(1.0, float(epoch) / cfg.warmup_epochs)
    cur_alpha = cfg.alpha * warmup + (1.0 - warmup) * 0.9
    cur_beta, cur_gamma = cfg.beta * warmup, cfg.gamma * warmup

    T, B, V = student_outputs["logits"].shape
    s_flat = student_outputs["logits"].reshape(-1, V).float()
    t_flat = teacher_outputs["logits"].reshape(-1, V).float()
    mask = _step_mask(T, B, lengths, s_flat.device)[0].reshape(-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    t_probs = torch.softmax(t_flat / cfg.temperature, -1)
    s_logp = torch.log_softmax(s_flat / cfg.temperature, -1)
    kd_rows = -(t_probs * s_logp).sum(-1)
    kd = (kd_rows * mask).sum() / denom * (cfg.temperature ** 2)
    hard = focal_loss(s_flat, targets.reshape(-1), cfg.focal_alpha,
                      cfg.focal_gamma, mask)
    token_loss = cur_alpha * kd + (1.0 - cur_alpha) * hard

    zero = torch.zeros((), device=s_flat.device)
    feature_loss = zero
    if ("encoder_features" in student_outputs
            and "encoder_features" in teacher_outputs):
        sf = student_outputs["encoder_features"].float()
        tf = teacher_outputs["encoder_features"].float()
        sn = sf / torch.clamp(sf.norm(dim=-1, keepdim=True), min=1e-12)
        tn = tf / torch.clamp(tf.norm(dim=-1, keepdim=True), min=1e-12)
        feature_loss = 1.0 - (sn * tn).sum(-1).mean()

    hidden_loss = zero
    sh = student_outputs.get("hidden_states")
    th = teacher_outputs.get("hidden_states")
    if sh is not None and th is not None and hidden_noise is not None:
        w = torch.softmax(hidden_noise.float(), dim=0)[..., None]
        hidden_loss = ((sh.float() * w).sum(0)
                       - (th.float() * w).sum(0)).square().mean()

    total = token_loss + cur_beta * feature_loss + cur_gamma * hidden_loss
    return total, {"total_loss": total, "token_kd_loss": token_loss,
                   "feature_kd_loss": feature_loss,
                   "hidden_kd_loss": hidden_loss, "kd_loss": kd,
                   "hard_loss": hard, "ce_loss": hard}
