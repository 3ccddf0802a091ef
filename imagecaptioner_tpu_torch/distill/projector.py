"""FeatureProjector: teacher -> student feature space
(``imagecaptioner_tpu/distill/projector.py``).

Linear + ReLU + Dropout(0.1) + LayerNorm when the widths differ; the
sequence is aligned (197 -> 49) by an adaptive average pool written as a
static matmul.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core.modules import (LayerNorm, Linear,
                                                   adaptive_avg_pool1d,
                                                   dropout, layer_norm_init,
                                                   linear_init)


class FeatureProjector(nn.Module):
    def __init__(self, teacher_dim: int, student_dim: int):
        super().__init__()
        self.feature_projection = None
        if teacher_dim != student_dim:
            self.feature_projection = nn.ModuleDict({
                "fc": Linear(teacher_dim, student_dim),
                "ln": LayerNorm(student_dim)})

    @staticmethod
    def init(rng: np.random.Generator, teacher_dim: int, student_dim: int
             ) -> dict:
        if teacher_dim == student_dim:
            return {}
        return {"feature_projection": {
            "fc": linear_init(rng, teacher_dim, student_dim),
            "ln": layer_norm_init(student_dim)}}

    def forward(self, features: torch.Tensor, *, teacher_seq_len: int = 197,
                student_seq_len: int = 64,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, teacher_seq_len, teacher_dim) -> (B, student_seq_len,
        student_dim)."""
        x = features
        if self.feature_projection is not None:
            x = torch.relu(self.feature_projection.fc(x))
            x = dropout(x, 0.1, self.training, generator)
            x = self.feature_projection.ln(x)
        if teacher_seq_len != student_seq_len:
            x = adaptive_avg_pool1d(x.transpose(1, 2), student_seq_len
                                    ).transpose(1, 2)
        return x


def make_projectors(teacher_embed: int, student_embed: int,
                    student_hidden: int) -> nn.ModuleDict:
    """The two projectors of ``create_feature_projectors``.  ``hidden`` is
    created and checkpointed but never applied: a reference quirk, kept for
    the checkpoint schema."""
    return nn.ModuleDict({
        "encoder": FeatureProjector(teacher_embed, student_embed),
        "hidden": FeatureProjector(teacher_embed, student_hidden)})


def create_feature_projectors(seed: int, *, teacher_embed: int,
                              student_embed: int, student_hidden: int,
                              student_seq_len: int = 49,
                              teacher_seq_len: int = 197
                              ) -> Tuple[dict, Dict]:
    """Random (params, meta) in the JAX layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = {
        "encoder": FeatureProjector.init(rng, teacher_embed, student_embed),
        "hidden": FeatureProjector.init(rng, teacher_embed, student_hidden)}
    return params, {"teacher_seq_len": teacher_seq_len,
                    "student_seq_len": student_seq_len}
