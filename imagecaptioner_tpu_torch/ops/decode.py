"""Student caption decoding and detokenization (``imagecaptioner_tpu/ops/decode.py``).

``best_greedy_decode_student`` keeps its JAX name and picks the path by the
tensor it is given:

* a CUDA tensor with ``rng=None``: the greedy kernel (``ops/greedy.py``);
* a CPU tensor with ``rng=None``: the kernel's plain version;
* ``rng`` (a ``torch.Generator``) given: the plain version, sampling from
  softmax(logits / temperature), on either device.  The JAX package has no
  sampling kernel either.

There is no fallback: a kernel that cannot take its inputs raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.models.student import check_variant
from imagecaptioner_tpu_torch.ops import greedy as G


def best_greedy_decode_student(student, feats: torch.Tensor,
                               cfg: StudentConfig, *, max_length: int = 20,
                               temperature: float = 1.0,
                               rng: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Greedy (or, with ``rng``, sampled) decode over refined features
    (B, L, E).  Returns (B, max_length) int32; PAD at and after the first
    END."""
    check_variant(cfg)
    w = G.greedy_operands(student.decoder, feats.dtype)
    f_proj = G.attention_feature_projection(w, feats)
    if rng is None and feats.is_cuda:
        return G.greedy_decode_cuda(w, feats, f_proj, max_length=max_length,
                                    temperature=temperature)
    if rng is None and feats.device.type != "cpu":
        raise ValueError(f"greedy decode: unsupported device {feats.device}")
    return G.greedy_decode_plain(w, feats, f_proj, max_length=max_length,
                                 temperature=temperature, generator=rng)


def tokens_to_words(tokens, vocab) -> List[str]:
    """(max_len,) decode output -> word list (PAD/START/END stripped)."""
    return vocab.decode(np.asarray(tokens).tolist())


def tokens_to_caption(tokens, vocab) -> str:
    return " ".join(tokens_to_words(tokens, vocab))
