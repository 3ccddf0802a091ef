"""Batch captioning CLI of the port: a directory of images -> captions JSONL.

``imagecaptioner_tpu/eval/serve.py`` with the same flags: ``--model
student`` captions by greedy decode (the full, compact or enhanced student,
as the checkpoint's ``model_type`` says), ``--model teacher`` by packed beam
search in the parameters' dtype as loaded (float32, or ``--dtype bfloat16``,
the serving point of ``bench.py``).  ``--int8`` serves a copy whose encoder
is quantized, ``--int8-full`` (teacher only) one whose transformer decoder
is too, and ``--int8-calibrate N`` bakes static activation scales from the
first N images (``int8_serving_copy``; ``ops/quant.py``,
``csrc/int8_conv.cu``).  ``--data-parallel`` is a no-op on one card and on
the CPU, as the reference serves without a mesh on one device; with several
cards visible it serves each batch split over every card
(``eval/serving.py``), and ``--batch`` must divide by the cards, as the JAX
CLI requires of its mesh's data axis.  A binary PPM (``.ppm``, which
the JAX CLI does not list) is decoded by numpy and any other image by PIL,
imported only then (``data/dataset.decode_image_file``), so the CLI runs on
PPM files on a machine without PIL, as ``make_greedy_captioner`` and
``make_beam_captioner`` (which take uint8 arrays) do.  Runs on
``--device`` (default ``cuda``): without a card it raises, and only
``--device cpu`` runs on the CPU.  Under a profiler each captioner call is
the span ``serve.call`` over ``serve.upload``, ``serve.encode``,
``serve.decode`` and ``serve.fetch`` (``core/spans.py``).

Usage:
  python -m imagecaptioner_tpu_torch.eval.serve \\
      --model student --checkpoint saved_models/best_student_model.npz \\
      --vocab saved_models/vocab.json --images data/flickr8k/Images \\
      --out captions.jsonl [--batch 16] [--max-length 20] [--temperature 1.0] \\
      [--int8 [--int8-calibrate N] [--int8-margin M]] \\
      [--dtype float32|bfloat16] [--device cuda|cpu]
  python -m imagecaptioner_tpu_torch.eval.serve --model teacher \\
      --checkpoint saved_models/best_teacher_model.npz [...] [--beam-size 5] \\
      [--int8 | --int8-full] [--int8-calibrate N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.modules import cast_parameters
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.core.spans import span
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.dataset import decode_image_file
from imagecaptioner_tpu_torch.data.vocabulary import START, Vocabulary
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import Teacher, load_teacher
from imagecaptioner_tpu_torch.ops import quant as Q
from imagecaptioner_tpu_torch.ops.decode import (beam_result_to_captions,
                                                 beam_search_teacher_packed,
                                                 best_greedy_decode_student,
                                                 greedy_decode_teacher,
                                                 tokens_to_caption)
from imagecaptioner_tpu_torch.utils.checkpoint import load_student_checkpoint
from imagecaptioner_tpu_torch.utils.convert import jax_student_to_state_dict

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".ppm")


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
        with span("serve.call"):
            with span("serve.upload"):
                x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
            with span("serve.encode"):
                _, refined = student.encode_image(T.normalize(x, dtype=dtype))
            with span("serve.decode"):
                toks = best_greedy_decode_student(
                    student, refined, cfg, max_length=max_length,
                    temperature=temperature, rng=rng)
            with span("serve.fetch"):
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
        with span("serve.call"):
            with span("serve.upload"):
                x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
            with span("serve.encode"):
                memory = teacher.encode_image(T.normalize(x, dtype=dtype))
            with span("serve.decode"):
                out = beam_search_teacher_packed(
                    teacher, memory, max_length=max_length,
                    beam_size=beam_size)
            with span("serve.fetch"):
                return tuple(t.cpu().numpy() for t in out)

    return caption


def int8_serving_copy(model, kind: str, *, int8: bool = False,
                      int8_full: bool = False,
                      calibrate_images: Optional[np.ndarray] = None,
                      margin: Optional[float] = None, max_length: int = 20,
                      verbose: bool = True):
    """The model the CLI serves for its int8 flags (``kind`` "student" or
    "teacher"): ``model`` itself without them; else a copy with the
    student's or the teacher's encoder quantized (``int8``), or the whole
    teacher (``int8_full``).  With ``calibrate_images`` (uint8 NHWC) the
    copy gets static activation scales from one eager forward on them, on
    the model's device and in its dtype: the student's ``encode_image``,
    the teacher's full forward under captions that the float teacher
    decodes greedily for them with START prepended (``int8_full``) or
    under a 2-token START placeholder (encoder only).  ``margin`` defaults
    to 1.25 with ``int8_full`` and to 1.0 otherwise."""
    if kind == "teacher" and int8_full:
        q = Q.quantize_teacher_full_int8(model)
    elif int8:
        q = (Q.quantize_teacher_encoder_int8(model) if kind == "teacher"
             else Q.quantize_student_encoder_int8(model))
    else:
        return model
    if calibrate_images is None:
        return q
    p = next(model.parameters())
    with torch.inference_mode():
        imgs = T.normalize(torch.from_numpy(
            np.ascontiguousarray(calibrate_images)).to(p.device),
            dtype=p.dtype)
    n = imgs.shape[0]
    if kind == "teacher":
        if int8_full:
            with torch.inference_mode():
                toks = greedy_decode_teacher(
                    model, model.encode_image(imgs), max_length=max_length)
            caps = torch.cat([torch.full((1, n), START, device=p.device),
                              toks.t().long()])
        else:
            caps = torch.full((2, n), START, device=p.device)

        def run(m):
            return m(imgs, caps)
    else:
        def run(m):
            return m.encode_image(imgs)
    if margin is None:
        margin = 1.25 if int8_full else 1.0
    q = Q.calibrate_activation_scales(q, run, margin=margin)
    if verbose:
        print(f"[int8] static activation scales calibrated on {n} images "
              f"(margin {margin})")
    return q


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
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving encoder (ops/quant.py)")
    ap.add_argument("--int8-full", action="store_true",
                    help="teacher only: int8 encoder and transformer decoder")
    ap.add_argument("--int8-calibrate", type=int, default=0, metavar="N",
                    help="with --int8/--int8-full: bake static activation "
                         "scales calibrated on the first N input images")
    ap.add_argument("--int8-margin", type=float, default=None,
                    help="headroom multiplier on calibrated scales "
                         "(default 1.0, 1.25 with --int8-full)")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="parameters and activations (default float32, as "
                         "the JAX CLI serves)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.int8_full and args.model != "teacher":
        ap.error("--int8-full applies to the teacher's transformer decoder; "
                 "students keep float decoders (use --int8)")
    if args.int8_calibrate and not (args.int8 or args.int8_full):
        ap.error("--int8-calibrate requires --int8 or --int8-full")
    cards = []       # serve over every card: eval/serving.py
    if (args.data_parallel and torch.device(args.device).type == "cuda"
            and torch.device(args.device).index is None
            and torch.cuda.device_count() > 1):
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if args.batch % len(cards):
            raise SystemExit(f"--batch {args.batch} must divide by the mesh "
                             f"data axis ({len(cards)})")

    device = resolve_device(args.device)
    dtype = as_dtype(args.dtype)
    from imagecaptioner_tpu_torch.eval import serving as SV

    vocab = Vocabulary.load(args.vocab)
    files = list_images(args.images)
    if not files:
        print(f"no images found under {args.images}")
        return 1
    def load(path, size):
        return decode_image_file(path, size)

    def calibration_images(size):
        if not args.int8_calibrate:
            return None
        n = max(1, min(args.int8_calibrate, len(files)))
        return np.stack([load(f, size) for f in files[:n]])

    int8_kw = dict(int8=args.int8, int8_full=args.int8_full,
                   margin=args.int8_margin, max_length=args.max_length)
    if args.model == "teacher":
        teacher, cfg = load_teacher(args.checkpoint, device, dtype)
        teacher = int8_serving_copy(
            teacher, "teacher", calibrate_images=calibration_images(
                cfg.image_size), **int8_kw)
        beam_fn = (SV.make_dp_beam_captioner(
            teacher, cfg, cards, max_length=args.max_length,
            beam_size=args.beam_size) if cards else make_beam_captioner(
                teacher, cfg, device, max_length=args.max_length,
                beam_size=args.beam_size))

        def caption_batch(arr: np.ndarray) -> List[str]:
            seqs, scores, _ = beam_fn(arr)
            return [beam_result_to_captions(seqs[i], scores[i], vocab, 1)[0]
                    for i in range(len(arr))]
    else:
        student, cfg = load_student(args.checkpoint, device, dtype)
        student = int8_serving_copy(
            student, "student", calibrate_images=calibration_images(
                cfg.image_size), **int8_kw)
        greedy_fn = (SV.make_dp_greedy_captioner if cards
                     else make_greedy_captioner)(
            student, cfg, cards or device, max_length=args.max_length,
            temperature=args.temperature, seed=args.seed)

        def caption_batch(arr: np.ndarray) -> List[str]:
            return [tokens_to_caption(t, vocab) for t in greedy_fn(arr)]

    size = cfg.image_size
    B = args.batch
    t0 = time.perf_counter()
    n_done = 0
    with open(args.out, "w") as out:
        for s in range(0, len(files), B):
            chunk = files[s:s + B]
            arr = np.stack([load(p, size) for p in chunk])
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
