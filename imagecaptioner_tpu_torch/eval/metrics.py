"""Caption metrics, the counterpart of ``imagecaptioner_tpu/eval/metrics.py``.

So far only ``monitoring_bleu``, the one the KD trainer's validation reads;
the rest of the reference module (BLEU-n, METEOR-F1, length and diversity
statistics) waits for the evaluators (ROADMAP Queue 1 C).
"""

from __future__ import annotations

from typing import Iterable


def monitoring_bleu(pred_ids: Iterable[int], target_ids: Iterable[int],
                    vocab) -> float:
    """Set-intersection BLEU-1 used inside training validation; ids 0/1/2
    (PAD, START, END) and ids outside ``vocab.itos`` stripped."""
    def words(ids):
        return {vocab.itos[int(i)] for i in ids
                if int(i) not in (0, 1, 2) and int(i) in vocab.itos}
    pred, target = words(pred_ids), words(target_ids)
    return len(pred & target) / len(target) if target else 0.0
