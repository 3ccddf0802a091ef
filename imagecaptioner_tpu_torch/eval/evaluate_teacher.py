"""Teacher evaluation of the port (``imagecaptioner_tpu/eval/evaluate_teacher.py``).

``CaptionEvaluator``: BLEU-1/2 (clipped n-gram precision), the simplified
METEOR-F1, caption length statistics and vocabulary diversity over a
dataset captioned by beam search, and a JSON report
(``evaluation_report.json``) with 20 sample captions.  Images go through
the packed beam search ``eval_batch`` at a time (on the card its two
attention cores are the kernels of ``ops/beam_attn.py``); a batch that
fails falls back to captioning its images one by one, and an image that
fails there is counted in ``success_rate``, as in the reference.  Unlike
the JAX package, which pads a trailing batch to its compiled shape, the last
batch here is as short as the data: the captions are the same.

Runs on ``--device`` (default ``cuda``; raises without a card):

  python -m imagecaptioner_tpu_torch.eval.evaluate_teacher \\
      --checkpoint saved_models/best_teacher_model.npz \\
      --vocab saved_models/vocab.json --data-root data/flickr8k \\
      [--captions-file ...] [--max-samples 500] \\
      [--output evaluation_report.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary
from imagecaptioner_tpu_torch.eval import metrics as MET
from imagecaptioner_tpu_torch.models.teacher import Teacher, load_teacher
from imagecaptioner_tpu_torch.ops import decode as D


def to_images(images_u8, device, dtype) -> torch.Tensor:
    """uint8 NHWC (numpy) -> normalized NCHW on ``device`` in ``dtype``."""
    x = torch.from_numpy(np.array(images_u8)).to(device)   # a writable copy
    return T.normalize(x, dtype=dtype)


def save_figure_of(image_u8: np.ndarray, title: str, path: str,
                   figsize) -> None:
    """The image under ``title``, saved to ``path`` (headless)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(image_u8)
    ax.axis("off")
    ax.set_title(title, fontsize=9, wrap=True)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


class CaptionEvaluator:
    def __init__(self, teacher: Teacher, cfg: TeacherConfig, vocab: Vocabulary,
                 device):
        self.teacher = teacher
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)
        self.dtype = next(teacher.parameters()).dtype

    # the reference's metric surface, method for method
    def bleu_score(self, predicted: str, reference: str, n: int = 1) -> float:
        return MET.bleu_n(predicted.lower().split(), reference.lower().split(),
                          n)

    def meteor_score_simple(self, predicted: str, reference: str) -> float:
        return MET.meteor_f1(predicted.lower().split(),
                             reference.lower().split())

    @torch.inference_mode()
    def caption_image(self, image_nchw: torch.Tensor, *, max_length=20,
                      beam_size=5, length_penalty=0.6,
                      num_return_sequences=1) -> List[str]:
        """One image (1, 3, H, W) -> its best ``num_return_sequences``
        captions."""
        memory = self.teacher.encode_image(image_nchw)
        seqs, scores, _ = D.beam_search_teacher(
            self.teacher, memory, max_length=max_length, beam_size=beam_size,
            length_penalty=length_penalty)
        return D.beam_result_to_captions(seqs.cpu(), scores.cpu(), self.vocab,
                                         num_return_sequences)

    @torch.inference_mode()
    def caption_images_batch(self, images_nchw: torch.Tensor, *,
                             max_length=20, beam_size=5,
                             length_penalty=0.6) -> List[str]:
        """(N, 3, H, W) -> N best-beam captions by the packed beam search,
        token-identical to the per-image search."""
        memory = self.teacher.encode_image(images_nchw)
        seqs, scores, _ = D.beam_search_teacher_packed(
            self.teacher, memory, max_length=max_length, beam_size=beam_size,
            length_penalty=length_penalty)
        seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
        return [D.beam_result_to_captions(seqs[i], scores[i], self.vocab, 1)[0]
                for i in range(seqs.shape[0])]

    def evaluate_on_dataset(self, dataset, *, max_samples: int = 500,
                            images_per_batch: int = 5, eval_batch: int = 16,
                            verbose: bool = True) -> Dict:
        """Beam captions against the references of the first
        ``max_samples`` rows."""
        n = min(max_samples, len(dataset))
        bleu1, bleu2, meteor = [], [], []
        captions_out, refs_out = [], []
        failures = 0
        for start in range(0, n, eval_batch):
            items = []
            for i in range(start, min(start + eval_batch, n)):
                try:
                    items.append(dataset[i])
                except Exception as e:  # the reference counts per-image errors
                    failures += 1
                    if verbose:
                        print(f"  [warn] sample {i} failed: {e}")
            if not items:
                continue
            images = to_images(np.stack([it[0] for it in items]), self.device,
                               self.dtype)
            try:
                preds = self.caption_images_batch(images)
            except Exception as e:
                if verbose:
                    print(f"  [warn] batch at {start} failed ({e}); "
                          "retrying per-image")
                preds = []
                for bi in range(len(items)):
                    try:
                        preds.append(self.caption_image(images[bi:bi + 1])[0])
                    except Exception as e2:
                        preds.append(None)
                        failures += 1
                        if verbose:
                            print(f"  [warn] sample failed: {e2}")
            for (_, cap_ids), pred in zip(items, preds):
                if pred is None:
                    continue
                ref = " ".join(self.vocab.decode(cap_ids))
                bleu1.append(self.bleu_score(pred, ref, 1))
                bleu2.append(self.bleu_score(pred, ref, 2))
                meteor.append(self.meteor_score_simple(pred, ref))
                captions_out.append(pred)
                refs_out.append(ref)
            done = min(start + eval_batch, n)
            if verbose and done % max(1, images_per_batch * 10) < eval_batch:
                print(f"  evaluated {done}/{n}")
        total = len(bleu1)
        words = [c.split() for c in captions_out]
        return {
            "num_samples": total,
            "success_rate": total / max(total + failures, 1),
            "bleu1": float(np.mean(bleu1)) if bleu1 else 0.0,
            "bleu2": float(np.mean(bleu2)) if bleu2 else 0.0,
            "meteor": float(np.mean(meteor)) if meteor else 0.0,
            "length_stats": MET.caption_length_stats(words),
            "diversity": MET.vocabulary_diversity(words),
            "samples": [{"generated": c, "reference": r}
                        for c, r in list(zip(captions_out, refs_out))[:20]],
        }

    def evaluate_single_image(self, dataset, index: int, *,
                              save_figure: Optional[str] = None) -> Dict:
        """Caption one dataset image; with ``save_figure``, also save it
        with its captions as a matplotlib figure."""
        img_u8, cap_ids = dataset[index]
        pred = self.caption_image(to_images(img_u8[None], self.device,
                                            self.dtype))[0]
        ref = " ".join(self.vocab.decode(cap_ids))
        result = {"generated": pred, "reference": ref,
                  "bleu1": self.bleu_score(pred, ref, 1),
                  "meteor": self.meteor_score_simple(pred, ref)}
        if save_figure:
            save_figure_of(img_u8, f"Generated: {pred}\nReference: {ref}",
                           save_figure, (6, 7))
            result["figure"] = save_figure
        return result

    def generate_report(self, dataset,
                        output_path: str = "evaluation_report.json",
                        **kw) -> Dict:
        report = self.evaluate_on_dataset(dataset, **kw)
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"Evaluation report saved to {output_path}")
        print(f"BLEU-1: {report['bleu1']:.4f}  BLEU-2: {report['bleu2']:.4f}  "
              f"METEOR: {report['meteor']:.4f}")
        return report


def load_teacher_evaluator(checkpoint_path: str, vocab_path: str,
                           device="cuda") -> CaptionEvaluator:
    """A teacher checkpoint (float32) and its vocabulary -> an evaluator on
    ``device``."""
    device = resolve_device(device)
    teacher, cfg = load_teacher(checkpoint_path, device)
    return CaptionEvaluator(teacher, cfg, Vocabulary.load(vocab_path), device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate the teacher model")
    ap.add_argument("--checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--vocab", default="saved_models/vocab.json")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--max-samples", type=int, default=500)
    ap.add_argument("--output", default="evaluation_report.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    evaluator = load_teacher_evaluator(args.checkpoint, args.vocab,
                                       args.device)
    captions = args.captions_file or os.path.join(args.data_root,
                                                  "captions_clean.csv")
    dataset = CaptionDataset(args.data_root, captions, vocab=evaluator.vocab,
                             image_size=evaluator.cfg.image_size)
    evaluator.generate_report(dataset, args.output,
                              max_samples=args.max_samples)
    return 0


if __name__ == "__main__":
    sys.exit(main())
