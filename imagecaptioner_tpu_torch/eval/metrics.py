"""Caption metrics of the port (``imagecaptioner_tpu/eval/metrics.py``), pure
Python.  The reference's evaluator math, simplified precision-only metrics
rather than sacrebleu:

  * BLEU-n: clipped n-gram precision, no brevity penalty;
  * "METEOR": unigram-overlap F1;
  * monitoring BLEU-1: set intersection over the target's word set, inside
    the KD trainer's validation;
  * caption length statistics and vocabulary diversity;
  * the best mean BLEU-1 a constant caption reaches, the floor a trained
    model must beat.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence


def ngram_precision(candidate: Sequence[str], reference: Sequence[str],
                    n: int) -> float:
    """Clipped n-gram precision; 0.0 when either side is shorter than n."""
    if len(candidate) < n or len(reference) < n:
        return 0.0
    cand = Counter(tuple(candidate[i:i + n])
                   for i in range(len(candidate) - n + 1))
    ref = Counter(tuple(reference[i:i + n])
                  for i in range(len(reference) - n + 1))
    if not cand:
        return 0.0
    overlap = sum(min(c, ref[g]) for g, c in cand.items())
    return overlap / sum(cand.values())


def bleu_n(candidate: Sequence[str], reference: Sequence[str], n: int) -> float:
    return ngram_precision(candidate, reference, n)


def adversarial_constant_bleu1(refs: Sequence[Sequence[str]],
                               extra_candidates: Iterable[Sequence[str]] = (),
                               max_len: int = 16) -> Dict:
    """Best mean BLEU-1 any constant caption reaches against ``refs``.  Two
    candidate families: every observed reference (plus
    ``extra_candidates``), and a constant built token by token (append the
    vocabulary token that raises the mean clipped precision most, up to
    ``max_len`` tokens).  Returns ``{"best_observed", "adversarial",
    "adversarial_tokens", "floor"}``, ``floor`` the larger score."""
    refs = [list(r) for r in refs]

    def mean_b1(cand):
        return sum(bleu_n(cand, r, 1) for r in refs) / len(refs)

    candidates = ({tuple(r) for r in refs}
                  | {tuple(c) for c in extra_candidates})
    best_obs = max((mean_b1(list(c)) for c in candidates), default=0.0)
    vocab = sorted({t for r in refs for t in r})
    adv: List[str] = []
    best_adv = 0.0
    for _ in range(max_len):
        sc, tok = max((mean_b1(adv + [t]), t) for t in vocab)
        if sc <= best_adv:
            break
        best_adv, adv = sc, adv + [tok]
    return {"best_observed": best_obs, "adversarial": best_adv,
            "adversarial_tokens": adv, "floor": max(best_obs, best_adv)}


def meteor_f1(candidate: Sequence[str], reference: Sequence[str]) -> float:
    """Unigram-overlap F1, the reference's "simplified METEOR"."""
    cand_set, ref_set = set(candidate), set(reference)
    if not ref_set:
        return 0.0
    overlap = len(cand_set & ref_set)
    recall = overlap / len(ref_set)
    precision = overlap / len(cand_set) if cand_set else 0.0
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def monitoring_bleu(pred_ids: Iterable[int], target_ids: Iterable[int],
                    vocab) -> float:
    """Set-intersection BLEU-1 used inside training validation; ids 0/1/2
    (PAD, START, END) and ids outside ``vocab.itos`` stripped."""
    def words(ids):
        return {vocab.itos[int(i)] for i in ids
                if int(i) not in (0, 1, 2) and int(i) in vocab.itos}
    pred, target = words(pred_ids), words(target_ids)
    return len(pred & target) / len(target) if target else 0.0


def caption_length_stats(captions: List[Sequence[str]]) -> Dict[str, float]:
    lengths = [len(c) for c in captions]
    if not lengths:
        return {"mean_length": 0.0, "min_length": 0, "max_length": 0}
    return {"mean_length": sum(lengths) / len(lengths),
            "min_length": min(lengths), "max_length": max(lengths)}


def vocabulary_diversity(captions: List[Sequence[str]]) -> Dict[str, object]:
    all_words = [w for c in captions for w in c]
    if not all_words:
        return {"unique_words": 0, "total_words": 0, "diversity_ratio": 0.0,
                "most_common": []}
    counts = Counter(all_words)
    return {"unique_words": len(counts), "total_words": len(all_words),
            "diversity_ratio": len(counts) / len(all_words),
            "most_common": counts.most_common(10)}
