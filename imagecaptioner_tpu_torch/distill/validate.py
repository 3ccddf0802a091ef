"""Pre-flight distillation check (``imagecaptioner_tpu/distill/validate.py``).

Runs one teacher and one student forward on a sample batch, projects the
teacher features, evaluates the loss once and prints shapes and components:
the self-test the reference performs before training starts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                  StudentConfig, TeacherConfig)
from imagecaptioner_tpu_torch.distill.losses import distillation_loss
from imagecaptioner_tpu_torch.distill.wrapper import teacher_forward_for_kd
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import Teacher


@torch.no_grad()
def validate_distillation_setup(teacher: Teacher, teacher_cfg: TeacherConfig,
                                student: Student, student_cfg: StudentConfig,
                                projectors: nn.ModuleDict,
                                sample_batch: Tuple[torch.Tensor, torch.Tensor],
                                *, verbose: bool = True) -> Dict[str, float]:
    """One dry run in eval mode; returns the loss components as floats."""
    images, captions = sample_batch
    teacher_out = teacher_forward_for_kd(teacher, images, captions)
    was_training = student.training
    student.eval()
    projectors.eval()
    logits, feats, hiddens, _ = student(images, captions)
    projected = projectors["encoder"](
        teacher_out["encoder_features"],
        teacher_seq_len=teacher_cfg.num_tokens,
        student_seq_len=student_cfg.feature_tokens)
    student.train(was_training)
    projectors.train(was_training)
    if verbose:
        print(f"Teacher logits shape: {tuple(teacher_out['logits'].shape)}")
        print(f"Student logits shape: {tuple(logits.shape)}")
        print("Teacher encoder features shape: "
              f"{tuple(teacher_out['encoder_features'].shape)}")
        print(f"Student encoder features shape: {tuple(feats.shape)}")
        print(f"Projected teacher features shape: {tuple(projected.shape)}")
    _, loss_dict = distillation_loss(
        {"logits": logits, "encoder_features": feats,
         "hidden_states": hiddens},
        dict(teacher_out, encoder_features=projected), captions,
        DistillConfig())
    comps = {k: float(v) for k, v in loss_dict.items()}
    if verbose:
        print("Distillation loss validation successful!")
        print("Loss components:", comps)
    return comps
