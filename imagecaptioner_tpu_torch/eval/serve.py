"""Batch captioning CLI of the port: a directory of images -> captions JSONL.

``imagecaptioner_tpu/eval/serve.py`` with the same flags: ``--model
student`` captions by greedy decode (the full, compact or enhanced student,
as the checkpoint's ``model_type`` says), ``--model teacher`` by packed beam
search in the parameters' dtype as loaded (float32).  ``--data-parallel``
is a no-op on one card and on the CPU, as the reference serves without a
mesh on one device; the flags whose paths are not ported yet (int8, data
parallelism over more than one card) exit with an error that says so.
Images are decoded with PIL, imported only here, so ``make_greedy_captioner``
and ``make_beam_captioner`` (which take uint8 arrays) run on a machine
without PIL.  Runs on ``--device`` (default ``cuda``): without a card it
raises, and only ``--device cpu`` runs on the CPU.

Usage:
  python -m imagecaptioner_tpu_torch.eval.serve \\
      --model student --checkpoint saved_models/best_student_model.npz \\
      --vocab saved_models/vocab.json --images data/flickr8k/Images \\
      --out captions.jsonl [--batch 16] [--max-length 20] [--temperature 1.0] \\
      [--device cuda|cpu]
  python -m imagecaptioner_tpu_torch.eval.serve --model teacher \\
      --checkpoint saved_models/best_teacher_model.npz [...] [--beam-size 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.modules import cast_parameters
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import Teacher, load_teacher
from imagecaptioner_tpu_torch.ops.decode import (beam_result_to_captions,
                                                 beam_search_teacher_packed,
                                                 best_greedy_decode_student,
                                                 tokens_to_caption)
from imagecaptioner_tpu_torch.utils.checkpoint import load_student_checkpoint
from imagecaptioner_tpu_torch.utils.convert import jax_student_to_state_dict

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")


def list_images(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.lower().endswith(IMAGE_EXTS))


def load_student(path: str, device, dtype: torch.dtype = torch.float32):
    """A JAX-format KD checkpoint -> ``(Student in eval mode on device,
    cfg)``; parameters in ``dtype``, batch-norm statistics float32."""
    params, cfg, mstate = load_student_checkpoint(path)
    model = Student(cfg)
    model.load_state_dict(jax_student_to_state_dict(params, mstate, cfg),
                          strict=True)
    cast_parameters(model, dtype)
    return model.to(device).eval(), cfg


def make_greedy_captioner(student: Student, cfg: StudentConfig, device, *,
                          max_length: int = 20, temperature: float = 1.0,
                          seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 images (B, H, W, 3) -> tokens (B, max_length) int32.

    Computes in the dtype of the student's parameters.  Temperature 1.0 is
    greedy; any other value samples.  Every batch samples from a generator
    seeded afresh with ``seed``, as the JAX CLI closes one
    ``PRNGKey(seed)`` into its jitted function: the same images give the
    same tokens in every batch."""
    dtype = next(student.parameters()).dtype

    @torch.inference_mode()
    def caption(images_u8: np.ndarray) -> np.ndarray:
        rng = None
        if temperature != 1.0:
            rng = torch.Generator(device=device).manual_seed(seed)
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
        _, refined = student.encode_image(T.normalize(x, dtype=dtype))
        toks = best_greedy_decode_student(
            student, refined, cfg, max_length=max_length,
            temperature=temperature, rng=rng)
        return toks.cpu().numpy()

    return caption


def make_beam_captioner(teacher: Teacher, cfg, device, *, max_length: int = 20,
                        beam_size: int = 5
                        ) -> Callable[[np.ndarray],
                                      Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """uint8 images (B, H, W, 3) -> ``(seqs (B, K, max_length + 1) int32
    incl. START, scores (B, K) sorted descending with -inf padding, lens
    (B, K) int32)``, by the packed beam search over ``encode_image``.

    Computes in the dtype of the teacher's parameters (``load_teacher``:
    float32, as the JAX CLI serves it)."""
    dtype = next(teacher.parameters()).dtype

    @torch.inference_mode()
    def caption(images_u8: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
        memory = teacher.encode_image(T.normalize(x, dtype=dtype))
        out = beam_search_teacher_packed(
            teacher, memory, max_length=max_length, beam_size=beam_size)
        return tuple(t.cpu().numpy() for t in out)

    return caption


def _not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet (ROADMAP Queue 1 {item}); "
                      "use python -m imagecaptioner_tpu.eval.serve")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch caption images")
    ap.add_argument("--model", choices=["teacher", "student"], required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--images", required=True, help="image file or directory")
    ap.add_argument("--out", default="captions.jsonl")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-length", type=int, default=20)
    ap.add_argument("--beam-size", type=int, default=5,
                    help="teacher only (students are greedy)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="student only; != 1.0 samples")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-full", action="store_true")
    ap.add_argument("--int8-calibrate", type=int, default=0, metavar="N")
    ap.add_argument("--int8-margin", type=float, default=None)
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.int8 or args.int8_full or args.int8_calibrate:
        raise _not_ported("int8 serving", "item 12")
    if (args.data_parallel and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        raise _not_ported("data-parallel serving", "item 13")

    device = resolve_device(args.device)

    from PIL import Image

    vocab = Vocabulary.load(args.vocab)
    files = list_images(args.images)
    if not files:
        print(f"no images found under {args.images}")
        return 1
    if args.model == "teacher":
        teacher, cfg = load_teacher(args.checkpoint, device)
        beam_fn = make_beam_captioner(teacher, cfg, device,
                                      max_length=args.max_length,
                                      beam_size=args.beam_size)

        def caption_batch(arr: np.ndarray) -> List[str]:
            seqs, scores, _ = beam_fn(arr)
            return [beam_result_to_captions(seqs[i], scores[i], vocab, 1)[0]
                    for i in range(len(arr))]
    else:
        student, cfg = load_student(args.checkpoint, device)
        greedy_fn = make_greedy_captioner(
            student, cfg, device, max_length=args.max_length,
            temperature=args.temperature, seed=args.seed)

        def caption_batch(arr: np.ndarray) -> List[str]:
            return [tokens_to_caption(t, vocab) for t in greedy_fn(arr)]

    size = cfg.image_size

    def load(path):
        im = Image.open(path).convert("RGB").resize((size, size),
                                                    Image.BILINEAR)
        return np.asarray(im, np.uint8)

    B = args.batch
    t0 = time.perf_counter()
    n_done = 0
    with open(args.out, "w") as out:
        for s in range(0, len(files), B):
            chunk = files[s:s + B]
            arr = np.stack([load(p) for p in chunk])
            if len(chunk) < B:  # keep one batch shape for the whole run
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], B - len(chunk), axis=0)])
            caps = caption_batch(arr)[:len(chunk)]
            for p, c in zip(chunk, caps):
                out.write(json.dumps({"image": os.path.basename(p),
                                      "caption": c}) + "\n")
            n_done += len(chunk)
    dt = time.perf_counter() - t0
    print(f"captioned {n_done} images -> {args.out} on {device} "
          f"({n_done / dt:.1f} img/s wall incl. kernel build)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
