"""Student-against-teacher comparison of the port
(``imagecaptioner_tpu/eval/evaluate_student.py``).

``StudentEvaluator``: student greedy and teacher beam captions of a
dataset, BLEU-1/2 and METEOR per model, success rates, per-image latency of
both models, the compression and speed-up ratios, and the
``student_vs_teacher_report.json`` schema with 20 sample comparisons.
Images go ``eval_batch`` at a time through the batched decoders; a batch
that fails falls back to one image at a time, and an image that fails there
counts against its model's ``success_rate``, as in the reference.  Unlike
the JAX package, which pads a trailing batch to its compiled shape, the last
batch here is as short as the data: the captions are the same.

On the card, every caption and every latency run decodes through the
variant's greedy kernel (``best_greedy_decode_student``: #1 for the full
student, #3 for the compact one) and the teacher's beam search through the
kernels of ``ops/beam_attn.py``.  The JAX package times the student with its
generic ``greedy_decode_student`` scan; its counterpart here is the plain
step loop, which would put a plain version on the card's path.  The
enhanced student has no greedy kernel in either package and decodes through
that plain loop on every device.  Parameter counts are parameters, not
buffers (batch-norm statistics are not counted), as the JAX package counts
its parameter trees.

Runs on ``--device`` (default ``cuda``; raises without a card):

  python -m imagecaptioner_tpu_torch.eval.evaluate_student \\
      --student-checkpoint saved_models/best_student_model.npz \\
      --teacher-checkpoint saved_models/best_teacher_model.npz \\
      --vocab saved_models/vocab.json --data-root data/flickr8k \\
      [--captions-file ...] [--max-samples 100] \\
      [--output student_vs_teacher_report.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import (STUDENT_CONFIGS,
                                                  StudentConfig, TeacherConfig)
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary
from imagecaptioner_tpu_torch.eval import metrics as MET
from imagecaptioner_tpu_torch.eval.evaluate_teacher import (save_figure_of,
                                                            to_images)
from imagecaptioner_tpu_torch.eval.latency import measure_inference_time
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import (Teacher, count_parameters,
                                                     load_teacher)
from imagecaptioner_tpu_torch.ops import decode as D
from imagecaptioner_tpu_torch.utils.checkpoint import load_checkpoint
from imagecaptioner_tpu_torch.utils.convert import jax_student_to_state_dict

# the model_config keys the reference's loader passes to the config
STUDENT_CONFIG_KEYS = ("embed_size", "hidden_size", "num_layers", "dropout",
                       "use_attention_refinement")


class StudentEvaluator:
    def __init__(self, student: Student, s_cfg: StudentConfig,
                 teacher: Teacher, t_cfg: TeacherConfig, vocab: Vocabulary,
                 device):
        self.student = student
        self.s_cfg = s_cfg
        self.teacher = teacher
        self.t_cfg = t_cfg
        self.vocab = vocab
        self.device = torch.device(device)
        self.s_dtype = next(student.parameters()).dtype
        self.t_dtype = next(teacher.parameters()).dtype

    # -- caption paths -------------------------------------------------------

    def _student_tokens(self, image_nchw: torch.Tensor,
                        max_length: int = 20) -> torch.Tensor:
        # the variant's greedy kernel on the card; the enhanced student,
        # which has none in either package, runs its plain step loop
        _, refined = self.student.encode_image(image_nchw.to(self.s_dtype))
        return D.best_greedy_decode_student(self.student, refined, self.s_cfg,
                                            max_length=max_length)

    def _teacher_tokens(self, image_nchw: torch.Tensor) -> torch.Tensor:
        memory = self.teacher.encode_image(image_nchw.to(self.t_dtype))
        return D.beam_search_teacher(self.teacher, memory)[0]

    @torch.inference_mode()
    def student_caption(self, image_nchw, *, max_length=20) -> str:
        toks = self._student_tokens(image_nchw, max_length)
        return D.tokens_to_caption(toks[0].cpu(), self.vocab)

    @torch.inference_mode()
    def teacher_caption(self, image_nchw, *, max_length=20,
                        beam_size=5) -> str:
        memory = self.teacher.encode_image(image_nchw.to(self.t_dtype))
        seqs, scores, _ = D.beam_search_teacher(
            self.teacher, memory, max_length=max_length, beam_size=beam_size)
        outs = D.beam_result_to_captions(seqs.cpu(), scores.cpu(), self.vocab,
                                         1)
        return outs[0] if outs else ""

    @torch.inference_mode()
    def student_captions_batch(self, images_nchw, *, max_length=20
                               ) -> List[str]:
        """(B, 3, H, W) -> B captions by one batched greedy decode."""
        toks = self._student_tokens(images_nchw, max_length).cpu().numpy()
        return [D.tokens_to_caption(t, self.vocab) for t in toks]

    @torch.inference_mode()
    def teacher_captions_batch(self, images_nchw, *, max_length=20,
                               beam_size=5) -> List[str]:
        """(B, 3, H, W) -> B captions by the packed beam search."""
        memory = self.teacher.encode_image(images_nchw.to(self.t_dtype))
        seqs, scores, _ = D.beam_search_teacher_packed(
            self.teacher, memory, max_length=max_length, beam_size=beam_size)
        seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
        out = []
        for n in range(seqs.shape[0]):
            caps = D.beam_result_to_captions(seqs[n], scores[n], self.vocab, 1)
            out.append(caps[0] if caps else "")
        return out

    # -- latency -------------------------------------------------------------

    @torch.inference_mode()
    def measure_latencies(self, image_nchw, *, num_runs=10
                          ) -> Dict[str, Dict]:
        """Per-image latency of both models, each run on its own input (the
        image moved below visual significance)."""
        def mk(i):
            return image_nchw + float(i) * 1e-6

        return {"student": measure_inference_time(self._student_tokens, mk,
                                                  num_runs=num_runs),
                "teacher": measure_inference_time(self._teacher_tokens, mk,
                                                  num_runs=num_runs)}

    # -- dataset comparison ----------------------------------------------------

    def compare_models_on_dataset(self, dataset, *, max_samples: int = 100,
                                  measure_latency_samples: int = 5,
                                  eval_batch: int = 16,
                                  verbose: bool = True) -> Dict:
        n = min(max_samples, len(dataset))
        res = {m: {"bleu1": [], "bleu2": [], "meteor": [], "captions": [],
                   "failures": 0} for m in ("student", "teacher")}
        comparisons = []
        lat_student, lat_teacher = [], []
        batch_fn = {"student": self.student_captions_batch,
                    "teacher": self.teacher_captions_batch}
        one_fn = {"student": self.student_caption,
                  "teacher": self.teacher_caption}

        for start in range(0, n, eval_batch):
            idxs = list(range(start, min(start + eval_batch, n)))
            items = [dataset[i] for i in idxs]
            images = to_images(np.stack([it[0] for it in items]), self.device,
                               torch.float32)
            batch_caps = {}
            for model in ("student", "teacher"):
                try:
                    batch_caps[model] = batch_fn[model](images)
                except Exception:  # degrade to per-image, count failures
                    caps = []
                    for bi in range(len(idxs)):
                        try:
                            caps.append(one_fn[model](images[bi][None]))
                        except Exception as e2:
                            caps.append(("<error>", e2))
                    batch_caps[model] = caps

            for bi, i in enumerate(idxs):
                ref = " ".join(self.vocab.decode(items[bi][1]))
                row = {"reference": ref}
                for model in ("student", "teacher"):
                    cap = batch_caps[model][bi]
                    if isinstance(cap, tuple):  # a per-image failure
                        res[model]["failures"] += 1
                        row[model] = f"<error: {cap[1]}>"
                        continue
                    c, r = cap.lower().split(), ref.lower().split()
                    res[model]["bleu1"].append(MET.bleu_n(c, r, 1))
                    res[model]["bleu2"].append(MET.bleu_n(c, r, 2))
                    res[model]["meteor"].append(MET.meteor_f1(c, r))
                    res[model]["captions"].append(cap)
                    row[model] = cap
                comparisons.append(row)
                if i < measure_latency_samples:
                    lat = self.measure_latencies(images[bi][None], num_runs=3)
                    lat_student.append(lat["student"]["mean_s"])
                    lat_teacher.append(lat["teacher"]["mean_s"])
            if verbose:
                print(f"  compared {len(comparisons)}/{n}")

        def agg(model):
            r = res[model]
            cnt = len(r["bleu1"])
            lat = lat_student if model == "student" else lat_teacher
            return {
                "bleu1": float(np.mean(r["bleu1"])) if cnt else 0.0,
                "bleu2": float(np.mean(r["bleu2"])) if cnt else 0.0,
                "meteor": float(np.mean(r["meteor"])) if cnt else 0.0,
                "success_rate": cnt / max(n, 1),
                "avg_inference_time_s": float(np.mean(lat)) if lat else None,
            }

        return {"student": agg("student"), "teacher": agg("teacher"),
                "num_samples": n, "comparisons": comparisons}

    def evaluate_single_image_comparison(self, dataset, index: int, *,
                                         save_figure: Optional[str] = None
                                         ) -> Dict:
        """Teacher and student captions of one image side by side; with
        ``save_figure``, also a matplotlib figure."""
        img_u8, cap_ids = dataset[index]
        image = to_images(img_u8[None], self.device, torch.float32)
        ref = " ".join(self.vocab.decode(cap_ids))
        s_cap = self.student_caption(image)
        t_cap = self.teacher_caption(image)
        result = {"reference": ref, "student": s_cap, "teacher": t_cap,
                  "student_bleu1": MET.bleu_n(s_cap.lower().split(),
                                              ref.lower().split(), 1),
                  "teacher_bleu1": MET.bleu_n(t_cap.lower().split(),
                                              ref.lower().split(), 1)}
        if save_figure:
            save_figure_of(img_u8, f"Teacher: {t_cap}\nStudent: {s_cap}\n"
                           f"Reference: {ref}", save_figure, (6, 8))
            result["figure"] = save_figure
        return result

    # -- report ----------------------------------------------------------------

    def generate_comparison_report(
            self, dataset,
            output_path: str = "student_vs_teacher_report.json",
            **kw) -> Dict:
        results = self.compare_models_on_dataset(dataset, **kw)
        s, t = results["student"], results["teacher"]
        student_n = count_parameters(self.student)
        teacher_n = count_parameters(self.teacher)
        report = {
            "summary": {
                "bleu1_ratio": s["bleu1"] / t["bleu1"] if t["bleu1"] else None,
                "bleu2_ratio": s["bleu2"] / t["bleu2"] if t["bleu2"] else None,
                "meteor_ratio": (s["meteor"] / t["meteor"]
                                 if t["meteor"] else None),
                "speedup": (t["avg_inference_time_s"] / s["avg_inference_time_s"]
                            if s["avg_inference_time_s"] else None),
                "compression_ratio": teacher_n / student_n,
                "student_parameters": student_n,
                "teacher_parameters": teacher_n,
            },
            "student": s,
            "teacher": t,
            "num_samples": results["num_samples"],
            "sample_comparisons": results["comparisons"][:20],
        }
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"Comparison report saved to {output_path}")
        summ = report["summary"]
        print(f"Student/Teacher BLEU-1 ratio: {summ['bleu1_ratio']}")
        print(f"Speedup: {summ['speedup']}  "
              f"Compression: {summ['compression_ratio']:.2f}x")
        return report


def load_student_evaluator(student_checkpoint: str, teacher_checkpoint: str,
                           vocab_path: str, device="cuda") -> StudentEvaluator:
    """A KD checkpoint of any variant (its ``model_type``), a teacher
    checkpoint and the vocabulary -> an evaluator on ``device``, both models
    in float32."""
    device = resolve_device(device)
    vocab = Vocabulary.load(vocab_path)
    ck = load_checkpoint(student_checkpoint)
    mc = dict(ck.get("model_config", {}))
    variant = mc.pop("model_type", "full")
    if variant not in STUDENT_CONFIGS:
        raise ValueError(f"unknown student model_type {variant!r}")
    s_cfg = STUDENT_CONFIGS[variant](
        int(ck["vocab_size"]),
        **{k: v for k, v in mc.items() if k in STUDENT_CONFIG_KEYS})
    student = Student(s_cfg)
    sd = ck["student_state_dict"]
    student.load_state_dict(jax_student_to_state_dict(
        sd["params"], sd["model_state"], s_cfg), strict=True)
    teacher, t_cfg = load_teacher(teacher_checkpoint, device)
    return StudentEvaluator(student.to(device).eval(), s_cfg, teacher, t_cfg,
                            vocab, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Compare student vs teacher")
    ap.add_argument("--student-checkpoint",
                    default="saved_models/best_student_model.npz")
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--vocab", default="saved_models/vocab.json")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--max-samples", type=int, default=100)
    ap.add_argument("--output", default="student_vs_teacher_report.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    ev = load_student_evaluator(args.student_checkpoint,
                                args.teacher_checkpoint, args.vocab,
                                args.device)
    captions = args.captions_file or os.path.join(args.data_root,
                                                  "captions_clean.csv")
    dataset = CaptionDataset(args.data_root, captions, vocab=ev.vocab,
                             image_size=ev.t_cfg.image_size)
    ev.generate_comparison_report(dataset, args.output,
                                  max_samples=args.max_samples)
    return 0


if __name__ == "__main__":
    sys.exit(main())
