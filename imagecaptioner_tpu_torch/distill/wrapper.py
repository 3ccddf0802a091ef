"""Teacher forward for KD (``imagecaptioner_tpu/distill/wrapper.py``).

One encoder pass serves the decoder's memory and the feature tap.  Outputs
are float32, carry no gradient, and ``hidden_states`` is None, which keeps
gamma (hidden-state KD) structurally dead in every real run, as in the
reference.

On a (data, model) world the frozen teacher may be placed for tensor
parallelism (``parallel/tp.place_teacher_tp``) and run inside the sequence
policy (``parallel/sp.sequence_sharding``), which the caller enters around
the step as JAX's callers do: its logits and encoder features come back
whole on every rank, and ``cast_teacher`` copies a placed teacher with its
shards.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from imagecaptioner_tpu_torch.core.modules import cast_parameters
from imagecaptioner_tpu_torch.models.teacher import Teacher


@torch.no_grad()
def cast_teacher(teacher: Teacher, dtype: torch.dtype,
                 into: Optional[Teacher] = None) -> Teacher:
    """The teacher with every floating parameter rounded to ``dtype``, as
    the JAX package's ``bf16_compute`` casts the whole parameter tree: the
    LayerNorms, embeddings, position embeddings, CLS token and biases too.
    ``into``, a copy an earlier call returned, is refilled in place; the
    teacher itself is left as it is.  A teacher placed by
    ``parallel/tp.py`` is copied shard by shard (the copy shares its
    mesh)."""
    if into is None:
        return cast_parameters(copy.deepcopy(teacher), dtype).eval()
    torch._foreach_copy_(list(into.parameters()), list(teacher.parameters()))
    return into


@torch.no_grad()
def teacher_forward_for_kd(teacher: Teacher, images: torch.Tensor,
                           captions: torch.Tensor, *,
                           compute_dtype: torch.dtype = torch.float32) -> Dict:
    """Returns {'logits' (T,B,V) f32, 'encoder_features' (B,tokens,E) f32,
    'hidden_states': None}.  ``compute_dtype`` is the dtype the frozen
    teacher runs in (bfloat16 under ``KDTrainConfig.teacher_bf16``): a
    teacher whose parameters are not in it yet runs as ``cast_teacher``
    rounds it (the KD step casts once a step and hands the cast teacher
    in).  The teacher runs in eval mode whatever mode it was left in."""
    if (compute_dtype != torch.float32
            and next(teacher.parameters()).dtype != compute_dtype):
        teacher = cast_teacher(teacher, compute_dtype)
    was_training = teacher.training
    teacher.eval()
    memory = teacher.encode_image(images.to(compute_dtype))
    logits = teacher(None, captions, memory=memory)
    teacher.train(was_training)
    return {"logits": logits.float(), "encoder_features": memory.float(),
            "hidden_states": None}
