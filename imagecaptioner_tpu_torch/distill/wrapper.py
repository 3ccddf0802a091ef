"""Teacher forward for KD (``imagecaptioner_tpu/distill/wrapper.py``).

One encoder pass serves the decoder's memory and the feature tap.  Outputs
are float32, carry no gradient, and ``hidden_states`` is None, which keeps
gamma (hidden-state KD) structurally dead in every real run, as in the
reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from imagecaptioner_tpu_torch.models.teacher import Teacher


@torch.no_grad()
def teacher_forward_for_kd(teacher: Teacher, images: torch.Tensor,
                           captions: torch.Tensor, *,
                           compute_dtype: torch.dtype = torch.float32) -> Dict:
    """Returns {'logits' (T,B,V) f32, 'encoder_features' (B,tokens,E) f32,
    'hidden_states': None}.  ``compute_dtype`` is the dtype the frozen
    teacher runs in (bfloat16 under ``KDTrainConfig.teacher_bf16``; its
    float32 weights are cast at use).  The teacher runs in eval mode
    whatever mode it was left in."""
    was_training = teacher.training
    teacher.eval()
    memory = teacher.encode_image(images.to(compute_dtype))
    logits = teacher(None, captions, memory=memory,
                     decoder_dtype=compute_dtype)
    teacher.train(was_training)
    return {"logits": logits.float(), "encoder_features": memory.float(),
            "hidden_states": None}
