#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py             # the whole run
    python3 chip_smoke.py --mutation  # only: do the checks catch a planted fault?

Imports nothing of JAX.  In order it:
  1. prints the card and its power limit, and exits non-zero without a card;
  2. builds every kernel from ``csrc/`` (one nvcc per source, started
     together);
  3. turns TF32 off (matmul and cuDNN), so float32 comparisons are float32;
  4. holds ``core.modules.dense`` at bf16 (bf16 operands on tensor cores,
     float32 result) against its float32 form within one bf16 ulp at the
     serving and KD shapes, forward and gradients, and checks by the
     profiler that the product is a bf16 GEMM; holds the attention-core kernel against its plain version at the
     refinement, ViT (B=16, and B=12 as the teacher trainer runs it) and
     teacher-decoder shapes (causal, and cross-attention with Lq != Lk) in
     all four pairings of float32 and bf16, and its gradients under
     autograd against autograd through the plain version; times it per call
     and queued at the seven shapes where the main paths launch it, beside
     SDPA;
  5. holds the greedy-decode kernel against its plain version at full width
     (B=32, L=49, E=256, H=512, V=2994, T=20), temperature 1 and 2 (float32
     every row; bf16 at most one row in 32 departing from the float64 plain
     version, and only at a near tie of its top two logits), and requires 20
     more runs to be bit-identical to the first;
  6. holds the decoder-scan kernels against their plain versions at the KD
     shapes (T=47, B=16, L=49, E=256, H=512), float32 and bf16: the forward
     with a random dropout mask and residuals, and without either (20 more
     runs of each bit-identical to the first); the
     reverse-time backward with random dh_tops and dattns, all eleven
     gradients, each of which must be non-degenerate and bit-identical in a
     second run; times the backward by stage; then the greedy kernel and
     both scan forms at B=40 (two chunks, the second of 8 rows) and B=5,
     against their plain versions with the same limits, and each chunked
     launch against a launch per chunk, bit for bit;
  7. drives the serving path: a full student from a numpy seed is written as
     a JAX-format checkpoint, reloaded through the serve path's loader in
     bf16, and captions 8 batches of 32 seeded uint8 224x224 images through
     ``make_greedy_captioner``; a float32 copy on the card is held against
     the all-plain CPU path on 4 images;
  8. drives the training path: a ViT-S/16 teacher from a numpy seed written
     as a JAX-format checkpoint, the in-memory grid data, and
     ``train_student_with_kd_on_loaders`` for 3 optimizer steps (A=2 x
     B=16, T=47, bf16 compute, dropout 0.3, ``KD_TRAIN_AUG``) with its
     preflight and validation pass; then one float32 step on the card
     against the same step on the CPU with the plain versions (dropout off,
     augmentation off, B=4).  Each path's launch counts are set to 0 just before it and read
     just after;
  9. holds the two beam-step attention kernels against their plain versions
     at the teacher's full width (N=16 and 32 images, K=5 beams, 8 heads,
     S=21 cache positions, L=197 memory tokens), float32 and bf16, random
     ancestry at pos 0, 7 and 20, lineages built as the beam search builds
     them and a table converged to one slot a position at pos 7 and 20,
     K=10 at S=21 and at S=64, pos=63 (the self kernel's rows staged in two
     chunks at float32), q as a column block of a packed projection; the
     self kernel's plan against the wrapper's; 20 more runs of each kernel
     at the last position bit-identical to the first;
 10. drives teacher beam serving: a ViT-S/16 teacher from a numpy seed with
     its cross-attention scaled up and its END bias raised (so that beams
     finish at different lengths), written as a JAX-format checkpoint,
     loaded through the serve path's loader, captions 8 batches of 16 seeded
     uint8 224x224 images through ``make_beam_captioner`` (K=5, max_length
     20) in float32, then in bf16; the float32 card path is held against the
     all-plain CPU path on 4 images, the bf16 kernel path against the
     all-plain path on the card; packs of 8, 16 and 32 images and the cost of
     the early-exit read are timed;
 11. drives the disk pipeline at full width: 96 grid images written as
     binary PPM with a Flickr8k-shaped ``captions_clean.csv`` (5 rows an
     image and 2 rows naming missing files, built so that the vocabulary
     at the trainer's threshold has exactly 2,994 tokens and T=47); times
     the loader's cold (decode) and warm (cache) epochs;
     ``train_student_with_kd(data_root, ...)`` for 3 steps (bf16 compute,
     float32 teacher) with its metric log, which must launch #2, #4/#5 and
     #6, take 3 steps, log 3 finite records and land the asynchronously
     written best checkpoint before it returns; a resume from that
     checkpoint for a second epoch (steps 3 -> 6, epoch 1 in the log,
     frozen parameters equal to the checkpoint's bit for bit, every
     trainable group moved); the student and teacher evaluators on the
     trained student (32 and 16 rows, float32), whose reports must caption
     every image (no failure absorbed by the per-image fallback), hold only
     finite numbers and launch #1, #2, #9 and #10; then, on a sharpened
     student and teacher, the batched greedy kernel (B=16) against the
     per-image one (B=1) on 8 images, the packed beam against the
     per-image beam on 4, and the card's report captions against the same
     evaluators on the CPU on 4 images (3 of 4 rows each), rows differing;
 11b. trains the teacher on the same dataset at full width (ViT-S/16 384 /
     12 / 6 heads, decoder 512 / 8 / 4, V=2,994, T=47) through
     ``train_teacher.train``: 3 steps of A=3 x B=12 (bf16 compute,
     ``TEACHER_TRAIN_AUG``, dropout 0.15), one validation pass, best and
     final checkpoints; every loss and gradient norm finite, every frozen
     parameter bit-equal to its initial value, every trainable group moved,
     the encoder's rate cosine(lr x 0.1) down to the unscaled eta_min, #2
     launched exactly 36 times a step (12 ViT blocks x 3 micro-batches; the
     train-mode decoder's attention dropout takes the plain softmax) and 20
     times a validation batch; resumes from the best checkpoint for one more
     epoch (epoch time 1.0 first, from the saved optimizer step and first
     moments bit for bit); beam-serves the final checkpoint on 16 images;
     one float32 step card against CPU (dropout and augmentation off, A=1,
     B=2; loss 1e-4, gradient norm 1e-3 relative, no launch on the CPU);
     times the bf16 step's span by CUDA events and its wall time on the
     host clock, and #2's plain backward at (12, 6, 197, 64) per call and
     queued;
 11c. trains the compact student with the optimized trainer on the same
     dataset (``train_student_with_kd_optimized``: 2 epochs of 3 steps of
     A=2 x B=16, bf16, images read at 256 by the numpy resize and cropped
     to 224 and rotated on the card, fast validation at 224): every loss
     term finite, the total equal to the token loss at epoch 0 and
     0.05 x the feature loss above it at epoch 1, each lr group's rate the
     float64 OneCycle of its scale (0.1, 1, 1.5) at every global step with
     its weight decay, #7 launched exactly twice a step and #2 printed a
     step; resumes from the best checkpoint into the next epoch (at the
     saved global step, from the saved first moments bit for bit); one
     float32 step card against CPU (dropout off, crop offsets, angles,
     jitter and flips handed in; loss terms 1e-5, gradient norm 1e-3
     relative); times the bf16 step;
 11d. runs the KD pipeline twin (``python -m
     imagecaptioner_tpu_torch.runners.run_kd_pipeline``) as a subprocess on
     the dataset, one epoch on the card: it must exit 0 and every artifact
     it lists must exist;
 11e. captions a 256-pixel PPM with the demo twin
     (``runners.streamlit_app.demo_caption_image``): the teacher's beam at
     T = 1.0 (#2, #9, #10), again with the pipeline's full student in the
     student column, and the full and the optimized compact students
     greedy at T = 1.0 (#1, #3);
 11f. exports the beam phase's sharpened teacher and the serving phase's
     full student to the reference pipeline's key naming, saves each in the
     reference's checkpoint dict with ``torch.save``, reads it back through
     ``load_reference_pth`` -> ``*_from_reference`` -> ``strict=True`` and
     serves one batch each (beam, 16 images; greedy, 32 images, bf16):
     parameters and outputs must equal the ``.npz`` path's bit for bit;
 12. the compact student (MobileNetV2, E=H=256, L=49): holds the attention
     kernel against plain at the enhanced refinement's shape (B=16, 8 heads,
     64x64, hd=48); the compact scan kernel against plain at T=47, B=16 (h,
     attn, c; float32 and bf16) and, under autograd, its gradients; serves 8
     batches of 32 images in bf16 through ``make_greedy_captioner`` (the
     compact greedy kernel) and holds float32 card against CPU on 4 images;
     holds the compact greedy kernel against plain at B=32, T=20 (float32
     token-identical, bf16 31 of 32 rows); runs
     ``train_student_with_kd_on_loaders(student_variant="compact")`` for 3
     optimizer steps, times 4 more, and compares one float32 step card
     against CPU; 20 more runs of each
     compact kernel at each dtype bit-identical to the first; then the
     compact greedy kernel at B=40 (two chunks, the second of 8 rows) and
     B=5 and the compact scan at B=24 (two chunks of 16 and 8) and B=5,
     against their plain versions with the same limits, each chunked launch
     against a launch per chunk bit for bit;
 13. the enhanced student (EfficientNet-B3, E=384, H=768, L=64): holds the
     enhanced scan kernel against plain at T=47, B=16 with and without
     dropout multipliers (rates 0.1 and 0.15), all eight outputs, float32 and
     bf16 (20 more runs of each bit-identical to the first), and its
     gradients under autograd; then at B=4 and B=24 (two chunks, the second
     of 8 rows) with the same limits, a chunked launch against a launch per
     chunk bit for bit; serves 8 batches of 32 images in
     bf16 through the plain step loop (which launches the attention kernel in
     the refinement) and holds float32 card against CPU, on 4 images and on
     the loop alone with features drawn per row; runs the KD trainer for 3
     steps, times 4 more, compares one float32 step card against CPU;
 14. prints kernel, plain and library times (CUDA events, median after
     warm-up), each kernel's bound, the chain floor of the six cooperative
     kernels (#1, #3, #4/#5, #6, #7, #8: the median of 2,000 empty grid
     barriers at the chain's grid times the barriers a run crosses), ptxas'
     registers and spills for them and for #9 (with #9's launch plan), and
     the end-to-end rates;
 15. prints the kernels JSON line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line.  ``--mutation`` builds
eleven faulty copies (a scan backward without its dropout mask, a beam
self-attention that ignores the ancestry table, one that stages every chunk
of rows from position 0, a beam cross-attention whose
bulk copy of V drops its last 16 keys, an enhanced scan whose attention
ignores its dropout multiplier, an enhanced scan whose LayerNorms combine
stale partials, an attention core whose causal mask is off by one, a greedy
decode whose blocks all read row 0's broadcast context, a scan forward whose
layer 1 reads the broadcast h0 without its mask, a compact greedy decode
whose row blocks all reduce row 0's partial argmaxes, a compact scan whose
cell reads the previous step's recurrent part at even steps) and expects
all eleven checks to fail.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from imagecaptioner_tpu_torch.core import modules as M
from imagecaptioner_tpu_torch.core.config import (STUDENT_CONFIGS,
                                                  DistillConfig,
                                                  KDTrainConfig,
                                                  OptimizedDistillConfig,
                                                  OptimizedKDTrainConfig,
                                                  TeacherConfig,
                                                  TeacherTrainConfig,
                                                  compact_student_config,
                                                  enhanced_student_config,
                                                  full_student_config)
from imagecaptioner_tpu_torch.data import dataset as DS
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset, write_ppm
from imagecaptioner_tpu_torch.data.loader import BatchLoader
from imagecaptioner_tpu_torch.data.synthetic import (make_grid_dataset,
                                                     make_grid_loaders)
from imagecaptioner_tpu_torch.data.vocabulary import (END, PAD, SPECIALS,
                                                      START, Vocabulary)
from imagecaptioner_tpu_torch.eval import evaluate_student as EVS
from imagecaptioner_tpu_torch.eval import evaluate_teacher as EVT
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.distill.losses import OPTIMIZED_LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models import student_enhanced as SE
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models import transformer as TD
from imagecaptioner_tpu_torch.models import teacher as TM
from imagecaptioner_tpu_torch.models.teacher import teacher_init
from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import beam_attn as BA
from imagecaptioner_tpu_torch.ops import decode as D
from imagecaptioner_tpu_torch.ops import enhanced_scan as ES
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops import lstm_scan as S
from imagecaptioner_tpu_torch.runners import streamlit_app as DEMO
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.train import optim as O
from imagecaptioner_tpu_torch.train import train_student_kd as TK
from imagecaptioner_tpu_torch.train import train_student_kd_optimized as OPT
from imagecaptioner_tpu_torch.train import train_teacher as TT
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils import reference_pth as RP
from imagecaptioner_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       load_student_checkpoint,
                                                       save_checkpoint)

VOCAB = 2994          # bench.py's serving point
BATCH, N_BATCHES, MAX_LEN = 32, 8, 20
SEED = 0
# refinement MHA, ViT MHSA (KD's frozen teacher, beam serving), ViT MHSA in
# the teacher trainer's step (B=12)
ATTN_SHAPES = [(32, 4, 49, 64), (16, 6, 197, 64), (12, 6, 197, 64)]
# the teacher decoder's shapes: (B, heads, Lq, Lk, causal), in a KD step
# (B=16) and in the teacher trainer's validation step (B=12)
ATTN_KD_SHAPES = [(16, 8, 47, 47, True), (16, 8, 47, 197, False),
                  (12, 8, 47, 47, True), (12, 8, 47, 197, False)]
ATTN_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# the KD step's shapes (KDTrainConfig defaults; max_caption_len 48)
KD_A, KD_B, KD_T, KD_IMAGES, KD_STEPS = 2, 16, 47, 96, 3
# Decoder-scan limits, as max abs error over the output's max abs value.
# float32: kernel and plain version do the same float32 arithmetic and only
# sum in another order.  The backward at bf16 too: it reads the same stored
# (rounded) residuals and computes in float32 on both sides.  The forward at
# bf16 rounds h to 8 bits at every step, and the recurrence carries a
# rounding step that falls the other way through the remaining steps: the
# plain version itself moves this much when it only sums in float64 instead
# of float32 (printed beside each check as the floor).
SCAN_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
SCAN_FWD_BF16_LIMIT = 2e-2

# teacher beam serving (TeacherConfig defaults; the serve CLI's batch)
BEAM_B, BEAM_BATCHES, BEAM_K = 16, 8, 5
BEAM_S, BEAM_L, BEAM_H = MAX_LEN + 1, 197, 8
BEAM_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# see sharpen_teacher: cross-attention in- and out-projection gains, END bias
BEAM_CROSS_IN_GAIN, BEAM_CROSS_GAIN, BEAM_END_BIAS = 8.0, 4.0, 1.2

# published peaks of one H100 SXM: HBM bytes/s; dense FLOP/s by operand type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, n: int = 40) -> float:
    """Device time of one call when the stream never runs dry: a long matrix
    product is queued first, the ``n`` calls are enqueued while it runs, and
    the events bracket the calls alone.  For kernels of a few microseconds
    ``median_ms`` reads the host's time to enqueue one call (the wrapper's
    checks, ctypes, the launch); this reads what the card spends."""
    fn()
    blocker = torch.empty((8192, 8192), device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.mm(blocker, blocker)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


ATTN_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
# kernel #2 where the main paths launch it: (B, heads, Lq, Lk, hd, causal,
# dtype of q, k and v)
ATTN_PATH_SHAPES = {
    "refinement": (32, 4, 49, 49, 64, False, torch.bfloat16),
    "vit": (16, 6, 197, 197, 64, False, torch.float32),
    "teacher_self": (16, 8, 47, 47, 64, True, torch.float32),
    "teacher_cross": (16, 8, 47, 197, 64, False, torch.float32),
    "enhanced_refinement": (16, 8, 64, 64, 48, False, torch.bfloat16),
    "teacher_train_vit": (12, 6, 197, 197, 64, False, torch.bfloat16),
    "teacher_train_vit_f32": (12, 6, 197, 197, 64, False, torch.float32),
}


def check_attention(dev, gen):
    """Kernel vs plain at the slice's shapes, in all four pairings of the
    q/k and v types (the output has v's type, and the limit is v's);
    returns the max_abs_err at the case the main path launches most (the
    ViT's float32 self-attention)."""
    main_err = None
    for shape in ATTN_SHAPES:
        for qk_dt, v_dt in ATTN_DTYPES:
            for causal in (False, True):
                q, k = (torch.randn(shape, device=dev, generator=gen
                                    ).to(qk_dt) for _ in range(2))
                v = torch.randn(shape, device=dev, generator=gen).to(v_dt)
                scale = shape[3] ** -0.5
                got = A.attention_core_cuda(q, k, v, causal=causal, scale=scale)
                ref = A.attention_core_plain(q, k, v, causal=causal, scale=scale)
                torch.cuda.synchronize()
                if got.dtype != v_dt or got.shape != ref.shape:
                    fail(f"attention {shape} {v_dt}: dtype/shape contract")
                err = (got.float() - ref.float()).abs().max().item()
                ok = err <= ATTN_LIMIT[v_dt]
                print(f"attention_core {shape} q,k {str(qk_dt)[6:]} v "
                      f"{str(v_dt)[6:]} causal={causal}: max_abs_err "
                      f"{err:.3e} (limit {ATTN_LIMIT[v_dt]:g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail("attention kernel disagrees with its plain version")
                if shape == ATTN_SHAPES[1] and qk_dt == v_dt == torch.float32 \
                        and not causal:
                    main_err = err
    return main_err


def time_attention(dev, gen):
    """Kernel #2 at each shape where a main path launches it: per call
    (CUDA events around one call: the host's enqueue for a kernel this
    short) and queued (the device's time, stream kept full), beside the
    plain version and SDPA (the yardstick, used nowhere in the port), and
    the bound.  Returns {shape name: dict}."""
    out = {}
    for name, (B, H, lq, lk, d, causal, dt) in ATTN_PATH_SHAPES.items():
        q = torch.randn((B, H, lq, d), device=dev, generator=gen).to(dt)
        k, v = (torch.randn((B, H, lk, d), device=dev, generator=gen).to(dt)
                for _ in range(2))
        sc = d ** -0.5
        kern = lambda: A.attention_core_cuda(q, k, v, causal=causal, scale=sc)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, scale=sc)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        pairs = B * H * lq * (lk if not causal else (lk + 1) / 2)
        t = dict(ms=median_ms(kern, 200), queued_ms=queued_ms(kern, 100),
                 sdpa_ms=median_ms(sdpa, 200), sdpa_queued_ms=queued_ms(sdpa, 100),
                 plain_ms=median_ms(lambda: A.attention_core_plain(
                     q, k, v, causal=causal, scale=sc), 50),
                 bound=bound_ms(nbytes(q, k, v, q), 4 * pairs * d, kind))
        print(f"attention_core {name} ({B},{H},{lq}x{lk},{d}) {kind} "
              f"causal={causal}: kernel {t['ms']:.4f} ms per call, "
              f"{t['queued_ms']:.4f} queued; SDPA {t['sdpa_ms']:.4f}, "
              f"{t['sdpa_queued_ms']:.4f} queued; plain {t['plain_ms']:.4f}; "
              f"bound {t['bound'][0]:.5f} by {t['bound'][1]}", flush=True)
        out[name] = t
    return out


def sharpen_decoder(dec: dict) -> None:
    """Scale the decoder's random weights in place so that its tokens depend
    on every part of a step.  At PyTorch's default init the argmax barely
    moves with the state (a whole batch emits one token), and token
    equality then checks little.  With these scales a greedy decode whose
    layer-1 forget gate reads the input gate changes about half the rows.
    The LSTM gain stays at 2: at 3 the bf16 recurrence amplifies one
    rounding step, and two plain decodes that differ only in their
    summation precision already disagree on several rows of 32.  The END
    bias makes some rows finish, so END -> PAD runs too."""
    for layer in dec["lstm"]:
        layer["weight_ih"] *= 2.0
        layer["weight_hh"] *= 2.0
    dec["attention"]["weight"] *= 4.0
    dec["attention_combine"]["weight"] *= 2.0
    for fc in ("fc1", "fc2"):
        dec["output_projection"][fc]["weight"] *= 8.0
    dec["output_projection"]["fc2"]["bias"][END] += 2.0


REPEATS = 20  # runs of a chain kernel that must be bit-identical
NEAR_TIE_ULPS = 4  # a bf16 row may depart only where the top two logits are this close
CHUNK_BATCHES = (40, 5)  # #1 and #4/#5 at two chunks (the second of 8 rows) and one odd chunk


@contextlib.contextmanager
def recorded_logits(into: list):
    """Append the logits of every step of ``G.greedy_decode_plain`` to
    ``into``: the plain loop picks each token through ``G.next_token``."""
    real = G.next_token

    def record(logits, *args, **kwargs):
        into.append(logits.detach().clone())
        return real(logits, *args, **kwargs)

    G.next_token = record
    try:
        yield into
    finally:
        G.next_token = real


def departures(got, ref, logits, temp):
    """For each row of ``got`` that departs from ``ref``: (row, first step
    that differs, the top-two gap of ``ref``'s logits there after the
    temperature, that gap in bf16 ulps of the top logit).  The rows agree
    on every earlier token, so the gap says how near a tie the choice was."""
    out = []
    for r in (got != ref).any(dim=1).nonzero().flatten().tolist():
        t = int((got[r] != ref[r]).nonzero()[0])
        top = torch.topk(logits[t][r].double() / temp, 2).values.tolist()
        ulp = 2.0 ** (math.floor(math.log2(max(abs(top[0]), 1e-30))) - 7)
        out.append((r, t, top[0] - top[1], (top[0] - top[1]) / ulp))
    return out


def show_departures(dep) -> str:
    return ", ".join(f"row {r} step {t} gap {g:.4g} ({u:.2f} ulp)"
                     for r, t, g, u in dep) or "none"


def check_greedy(decoder, feats32, mutant=False, timed=True):
    """Kernel vs plain at full width, any batch; then the same call REPEATS
    times, which must repeat bit for bit (a race in the cross-block
    exchange shows there).  float32: every row identical to the plain
    version.  bf16: against the plain version summed in float64 (the exact
    trajectory of the rounded recurrence), at most one row in 32 (at least
    one) may depart, and only at a near tie: at its first differing step the
    float64 top-two logit gap must be within NEAR_TIE_ULPS bf16 ulps of the
    top logit.  Two float32 summations each leave the float64 trajectory in
    about one row of 32 where a rounding of h or of the logits lands the
    other way, in different rows, so the plain float32 version is no sharper
    reference than that; its departures and the kernel's rows against it
    are printed beside.  Returns (max |token diff| over the float32 runs,
    fewest bf16 rows identical, kernel ms, plain ms), the times only when
    ``timed``."""
    B = feats32.shape[0]
    allowed = -(-B // 32)
    max_diff, bf16_rows = 0, B
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype).contiguous()
        w = G.greedy_operands(decoder, dtype)
        f_proj = G.attention_feature_projection(w, feats)
        for temp in (1.0, 2.0):
            got = G.greedy_decode_cuda(w, feats, f_proj, max_length=MAX_LEN,
                                       temperature=temp)
            ref32 = G.greedy_decode_plain(w, feats, f_proj, max_length=MAX_LEN,
                                          temperature=temp)
            with recorded_logits([]) as logits64:
                ref64 = G.greedy_decode_plain(w, feats, f_proj,
                                              max_length=MAX_LEN,
                                              temperature=temp,
                                              acc_dtype=torch.float64)
            torch.cuda.synchronize()
            f32 = dtype == torch.float32
            ref = ref32 if f32 else ref64
            distinct, ended = token_power(ref, B, "greedy")
            rows = int((got == ref).all(dim=1).sum())
            diff = int((got.long() - ref.long()).abs().max())
            need = B if f32 else B - allowed
            beside = int((got == ref32).all(dim=1).sum())
            floor = int((ref64 == ref32).all(dim=1).sum())
            ok = rows >= need
            ties = ""
            if not f32:
                dep = departures(got, ref64, logits64, temp)
                ok = ok and all(u <= NEAR_TIE_ULPS for *_, u in dep)
                ties = (f"; kernel departs at {show_departures(dep)} (each "
                        f"must be within {NEAR_TIE_ULPS} ulp); plain float32 "
                        f"departs at {show_departures(departures(ref32, ref64, logits64, temp))}")
            print(f"greedy_decode B={B} {str(dtype)[6:]} T={temp}: "
                  f"{rows}/{B} rows identical to the plain version summed in "
                  f"{'float32' if f32 else 'float64'} (need {need}); "
                  f"reference has {distinct} distinct rows, {ended} ending; "
                  f"beside: kernel vs plain float32 {beside}/{B}, plain "
                  f"float32 vs float64 {floor}/{B}{ties} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("greedy kernel disagrees with its plain version")
            if f32:
                max_diff = max(max_diff, diff)
            else:
                bf16_rows = min(bf16_rows, rows)
        if not mutant:
            same = all(torch.equal(got, G.greedy_decode_cuda(
                w, feats, f_proj, max_length=MAX_LEN, temperature=temp))
                for _ in range(REPEATS))
            print(f"greedy_decode B={B} {str(dtype)[6:]}: {REPEATS} more runs "
                  f"bit-identical to the first: {same} "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            if not same:
                fail("greedy kernel: repeated runs differ")
    if mutant or not timed:
        return max_diff, bf16_rows, None, None
    feats = feats32.to(torch.bfloat16).contiguous()
    w = G.greedy_operands(decoder, torch.bfloat16)
    f_proj = G.attention_feature_projection(w, feats)
    kms = median_ms(lambda: G.greedy_decode_cuda(
        w, feats, f_proj, max_length=MAX_LEN), 20, 3)
    pms = median_ms(lambda: G.greedy_decode_plain(
        w, feats, f_proj, max_length=MAX_LEN), 10, 2)
    return max_diff, bf16_rows, kms, pms


def check_chain_batches(g_decoder, s_decoder, dev):
    """#1 and both forms of #4/#5 at the batches of CHUNK_BATCHES, which the
    main path's shapes (B=32, B=16) do not reach: a launch of two chunks
    whose second has 8 rows (mma pads them to 16), and one odd batch of 5.
    Each is held against its plain version with the limits of the main
    check, and a launch of several chunks must equal separate launches of
    each chunk, bit for bit (rows are independent and every sum runs in a
    fixed order)."""
    cfg = decoder_cfg()
    for B in CHUNK_BATCHES:
        feats32 = torch.from_numpy(np.random.default_rng(SEED + 20 + B)
                                   .standard_normal((B, cfg.feature_tokens,
                                                     cfg.embed_size))
                                   .astype(np.float32)).to(dev)
        with torch.inference_mode():
            check_greedy(g_decoder, feats32, timed=False)
            for dtype in (torch.float32, torch.bfloat16):
                feats = feats32.to(dtype).contiguous()
                w = G.greedy_operands(g_decoder, dtype)
                f_proj = G.attention_feature_projection(w, feats)
                whole = G.greedy_decode_cuda(w, feats, f_proj,
                                             max_length=MAX_LEN)
                parts = torch.cat([G.greedy_decode_cuda(
                    w, feats[b:b + 32].contiguous(),
                    f_proj[b:b + 32].contiguous(), max_length=MAX_LEN)
                    for b in range(0, B, 32)])
                chunk_same(f"greedy_decode B={B} {str(dtype)[6:]}",
                           [whole], [parts])
        for dtype in (torch.float32, torch.bfloat16):
            check_scan_forward(s_decoder, dev, dtype, B)


def chunk_same(what, whole, parts):
    same = all(torch.equal(x, y) for x, y in zip(whole, parts))
    print(f"{what}: one launch of every chunk bit-identical to a launch per "
          f"chunk: {same} {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail(f"{what}: the chunked launch differs from its chunks' launches")


def greedy_inputs(dev):
    """The sharpened full-width decoder of the serving path (the same
    weights ``main`` writes to its checkpoint) and features drawn per row."""
    cfg = full_student_config(VOCAB)
    params, _ = student_init(SEED, cfg)
    sharpen_decoder(params["decoder"])
    decoder = L.FullDecoder(cfg)
    decoder.load_state_dict(CV.tree_to_state_dict(params["decoder"]),
                            strict=True)
    feats32 = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, cfg.feature_tokens, cfg.embed_size)).astype(np.float32)).to(dev)
    return decoder.to(dev), feats32


def ptxas_usage(src: str, kernel: str):
    """Registers and spill bytes ptxas reported for each instance of
    ``kernel`` in the build log of the library loaded for ``src``, by operand
    type; None when that library has no log (it was not built here)."""
    out, fn = {}, None
    for line in _build.build_log(src).splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split()[-3 if "Compiling" in line else -1].strip("'")
        if fn is None or kernel not in fn:
            continue
        kind = "bf16" if "bfloat16" in fn else "float32"
        rec = out.setdefault(kind, {})
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            rec["spill_stores"] = int(parts[parts.index("spill") - 2])
            rec["spill_loads"] = int(parts[-4])
        if "Used" in line and "registers" in line:
            parts = line.split()
            rec["registers"] = int(parts[parts.index("registers,") - 1]
                                   if "registers," in parts
                                   else parts[parts.index("registers") - 1])
    return out or None


PROBE = "chain_probe"  # csrc/chain_probe.cu: the chains' grid barrier alone


def chain_barrier_ns(blocks: int, n: int, dev) -> list:
    """Times of ``n`` empty grid barriers on ``blocks`` co-resident blocks of
    512 threads in one cooperative launch, in ns each: block 0's clock64()
    after every barrier, scaled to ns by the launch's %globaltimer span."""
    lib = _build.library(PROBE)
    fn = lib.ic_chain_barrier_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    clk = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    gt = torch.zeros(2, dtype=torch.int64, device=dev)
    bar = torch.zeros(4, dtype=torch.int32, device=dev)
    err = _build.call_on(dev, fn, blocks, n, clk.data_ptr(), gt.data_ptr(),
                         bar.data_ptr())
    _build.check(lib, err, "chain barrier probe")
    clk, gt = clk.cpu().tolist(), gt.cpu().tolist()
    ns_per_cycle = (gt[1] - gt[0]) / max(clk[-1] - clk[0], 1)
    return [(b - a) * ns_per_cycle for a, b in zip(clk, clk[1:])]


def chain_floors(dev, names=None):
    """The least time each cooperative chain's barriers take: the median of
    2,000 empty grid barriers at the chain's own grid (one launch each),
    times the barriers a run of the chain crosses at the main path's shapes
    (#1: 5 a step and 2 more for the last token, B=32, T=20; #4/#5: 5 a
    step, T=47; #6's reverse chain: 5 a step less one; #8: 8 a step,
    T=47; #3: 3 a step and 1 more for the last token, T=20; #7: 3 a step,
    T=47)."""
    cfg, ccfg = decoder_cfg(), compact_student_config(VOCAB)
    L_, E, H = cfg.feature_tokens, cfg.embed_size, cfg.hidden_size
    cL, cE, cH = ccfg.feature_tokens, ccfg.embed_size, ccfg.hidden_size
    bf = torch.bfloat16
    chains = {
        "greedy_decode": (lambda: G.greedy_blocks(bf, dev, L_, E, H, VOCAB),
                          5 * MAX_LEN + 2),
        "decoder_scan": (lambda: S.decoder_scan_blocks(bf, dev, L_, E, H),
                         5 * KD_T),
        "decoder_scan_bwd": (lambda: S.chain_blocks(bf, dev, KD_B, L_, E, H),
                             5 * KD_T - 1),
        "enhanced_scan": (lambda: ES.enhanced_scan_blocks(
            bf, dev, ENH_L, ENH_E, ENH_H, ENH_NH), 8 * KD_T),
        "greedy_decode_compact": (lambda: G.greedy_compact_blocks(
            bf, dev, cL, cE, cH, VOCAB), 3 * MAX_LEN + 1),
        "compact_scan": (lambda: S.compact_scan_blocks(bf, dev, cL, cE, cH),
                         3 * KD_T)}
    out = {}
    for name, (grid, n_bar) in chains.items():
        if names is not None and name not in names:
            continue
        blocks = grid()
        ns = statistics.median(chain_barrier_ns(blocks, 2000, dev))
        out[name] = dict(blocks=blocks, barrier_us=ns / 1e3, barriers=n_bar,
                         floor_ms=n_bar * ns / 1e6)
        print(f"chain floor {name}: {blocks} blocks, median barrier "
              f"{ns / 1e3:.3f} us x {n_bar} barriers = "
              f"{n_bar * ns / 1e6:.4f} ms", flush=True)
    return out


# dense at bf16 where the main paths run it: serving's f_proj (B=32 x 49
# tokens), the KD step's output head fc1 and fc2 (T=47 x B=16 rows)
DENSE_SHAPES = [(BATCH * 49, 256, 256), (KD_T * KD_B, 512, 256),
                (KD_T * KD_B, 256, VOCAB)]


def check_dense(dev):
    """``core.modules.dense`` at bf16 on the card against its float32 form
    (operands widened to float32, the product in float32), forward and both
    gradients: each element within one bf16 ulp of the float32 form's, plus
    what two float32 sums of the same exact products may differ by in any
    order (K·2⁻²⁴·Σ|terms|, which matters only where the sum cancels to a
    value far below its terms).  Then the profiler's kernel names of one
    call: a bf16 product and no float32 GEMM."""
    rng = np.random.default_rng(SEED + 9)
    u32 = 2.0 ** -24
    for rows, k, n in DENSE_SHAPES:
        x = seeded(rng, (rows, k), dev, torch.bfloat16)
        w = seeded(rng, (n, k), dev, scale=k ** -0.5)
        b = seeded(rng, (n,), dev)
        dy = seeded(rng, (rows, n), dev, torch.bfloat16)
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        got = M.dense(xa, wa, b)
        got.backward(dy)
        xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ref = F.linear(xb.float(), wb.to(torch.bfloat16).float(),
                       b).to(torch.bfloat16)
        ref.backward(dy)
        ax, aw, ag = (t.float().abs() for t in (x, w.to(torch.bfloat16), dy))
        terms = {"y": (k, ax @ aw.t() + b.abs()), "dx": (n, ag @ aw),
                 "dW": (rows, ag.t() @ ax)}
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, r in (("y", got, ref), ("dx", xa.grad, xb.grad),
                           ("dW", wa.grad, wb.grad)):
            r = r.float()
            ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
                             - 7)
            K, mag = terms[name]
            over = ((g.float() - r).abs() / (ulp + K * u32 * mag)).max().item()
            worst = max(worst, over)
        ok = got.dtype == torch.bfloat16 and worst <= 1.0
        print(f"dense bf16 ({rows}x{k}) -> {n}: largest error {worst:.3f} of "
              f"its bound (one bf16 ulp + the float32 sum-order bound) over "
              f"y, dx, dW (limit 1) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("bf16 dense disagrees with its float32 form")
    x = seeded(rng, DENSE_SHAPES[2][:2], dev, torch.bfloat16)
    w = seeded(rng, DENSE_SHAPES[2][2:0:-1], dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        M.dense(x, w, None)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    gemms = [k for k in names if "gemm" in k.lower() or "xmma" in k.lower()
             or "cutlass" in k.lower()]
    # a float32 GEMM (sgemm, or any product kernel without bf16 operands)
    ok = bool(gemms) and all("bf16" in k.lower() for k in gemms)
    print(f"dense bf16 kernels: {gemms} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("bf16 dense did not run a bf16 product, or ran a float32 GEMM")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(bytes_moved: float, flops: float, kind: str):
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate for their type."""
    by_bytes, by_ops = bytes_moved / HBM_BPS, flops / PEAK[kind]
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_attention_kd(dev, gen):
    """The teacher decoder's attention shapes (causal self-attention and
    cross-attention with Lq != Lk), kernel against plain in all four
    pairings of the q/k and v types (the teacher trainer's bf16 validation
    step gives the cross-attention float32 q/k and bf16 v); then the kernel
    under autograd at the refinement shape and at the teacher trainer's ViT
    shape: its gradients (``attention_core_grads``, the plain recompute)
    against autograd through the plain version."""
    for (B, H, Lq, Lk, causal) in ATTN_KD_SHAPES:
        for qk_dt, v_dt in ATTN_DTYPES:
            q = torch.randn((B, H, Lq, 64), device=dev, generator=gen).to(qk_dt)
            k = torch.randn((B, H, Lk, 64), device=dev, generator=gen).to(qk_dt)
            v = torch.randn((B, H, Lk, 64), device=dev, generator=gen).to(v_dt)
            got = A.attention_core_cuda(q, k, v, causal=causal, scale=0.125)
            ref = A.attention_core_plain(q, k, v, causal=causal, scale=0.125)
            torch.cuda.synchronize()
            if got.dtype != v_dt or got.shape != ref.shape:
                fail(f"attention ({B},{H},{Lq}x{Lk}) {v_dt}: dtype/shape "
                     f"contract")
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= ATTN_LIMIT[v_dt]
            print(f"attention_core ({B},{H},{Lq}x{Lk},64) q,k "
                  f"{str(qk_dt)[6:]} v {str(v_dt)[6:]} causal={causal}: "
                  f"max_abs_err {err:.3e} (limit {ATTN_LIMIT[v_dt]:g}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("attention kernel disagrees with its plain version")
    q = torch.randn((2, 2, 5, 64), device=dev, generator=gen)
    k = torch.randn((2, 2, 9, 64), device=dev, generator=gen)
    try:
        A.attention_core_cuda(q, k, k, causal=True, scale=0.125)
    except ValueError:
        pass
    else:
        fail("the attention wrapper took a causal mask with Lq != Lk")
    for shape, dtype in itertools.product(
            ((KD_B, 4, 49, 64), (TEACH_B, 6, 197, 64)),
            (torch.float32, torch.bfloat16)):
        qkv = [torch.randn(shape, device=dev, generator=gen).to(dtype)
               for _ in range(3)]
        g = torch.randn(shape, device=dev, generator=gen).to(dtype)
        a = [t.clone().requires_grad_(True) for t in qkv]
        b = [t.clone().requires_grad_(True) for t in qkv]
        before = A.launches
        (A.attention_core(*a, scale=0.125).float() * g.float()).sum().backward()
        if A.launches != before + 1:
            fail("attention under autograd did not launch the kernel once")
        (A.attention_core_plain(*b, scale=0.125).float() * g.float()
         ).sum().backward()
        torch.cuda.synchronize()
        err = max((x.grad.float() - y.grad.float()).abs().max().item()
                  for x, y in zip(a, b))
        top = max(y.grad.float().abs().max().item() for y in b)
        ok = err <= ATTN_LIMIT[dtype] * max(top, 1.0)
        print(f"attention_core under autograd {shape} {str(dtype)[6:]}: "
              f"gradient max_abs_err {err:.3e} (largest {top:.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("attention gradients disagree with the plain version's")


def scan_operands(decoder, dev, dtype, seed, B=KD_B):
    """The twelve operands of the decoder scan at the KD shapes (batch ``B``),
    from a full-width decoder at its default init, seeded features, tokens
    and a keep-0.7 dropout mask, prepared as ``full_decoder_apply`` prepares
    them."""
    cfg = decoder_cfg()
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal(
        (B, cfg.feature_tokens, cfg.embed_size)).astype(np.float32)
        ).to(dev).to(dtype)
    caps = torch.from_numpy(rng.integers(0, VOCAB, (KD_T, B))).to(dev)
    keep = torch.from_numpy(rng.random((KD_T, B, cfg.hidden_size)) < 0.7)
    mask = (keep.float() / 0.7).to(dev)
    E, H = cfg.embed_size, cfg.hidden_size
    with torch.no_grad():
        f_proj = M.dense(feats, decoder.attention.weight[:, H:],
                         decoder.attention.bias)
        emb_w = M.dense(decoder.embedding(caps).to(dtype),
                        decoder.attention_combine.weight[:, :E],
                        decoder.attention_combine.bias)
        weights = L.decoder_scan_weights(decoder, dtype)
    return (emb_w.contiguous(), f_proj.contiguous(), feats.contiguous(),
            mask) + tuple(w.detach() for w in weights)


def decoder_cfg():
    return full_student_config(VOCAB, dropout=KDTrainConfig().dropout)


def rel_errs(names, got, ref, mean=False):
    """[(name, max abs error, max abs of the reference)] per output; with
    ``mean`` the mean abs error and the mean abs of the reference."""
    out = []
    for n, g, r in zip(names, got, ref):
        d, a = (g.float() - r.float()).abs(), r.float().abs()
        out.append((n, (d.mean() if mean else d.max()).item(),
                    (a.mean() if mean else a.max()).item()))
    return out


def report(what, rows, limit, floor=None, mean=False, brief=False):
    """Print and judge each row (name, error, scale); with ``brief`` only
    the row with the largest relative error is printed when all pass."""
    worst = 0.0
    err_name, top_name = ("mean_abs_err", "mean abs value") if mean \
        else ("max_abs_err", "largest value")
    rels = [err / top if top > 0 else float("inf") for _, err, top in rows]
    show = {rels.index(max(rels))} if brief and max(rels) <= limit else None
    for i, (n, err, top) in enumerate(rows):
        rel = rels[i]
        extra = "" if floor is None else \
            f"; plain f64-vs-f32 sums differ by {floor[i][1]:.3e}"
        ok = top > 0 and rel <= limit
        if show is None or i in show:
            lead = f"{what} (worst of {len(rows)})" if show else what
            print(f"{lead} {n}: {err_name} {err:.3e}, {top_name} {top:.3e}, "
                  f"relative {rel:.3e} (limit {limit:g}){extra} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        if top <= 0:
            fail(f"{what} {n} is degenerate (all zero): the check has no power")
        if not ok:
            fail(f"{what}: the kernel disagrees with its plain version on {n}")
        worst = max(worst, err)
    return worst


def scan_chunk(ops, b, n):
    """The scan operands of batch rows [b, b + n): emb_w and mask are
    (T, B, ·), f_proj and feats (B, L, E), the weights shared."""
    emb_w, f_proj, feats, mask = ops[:4]
    return (emb_w[:, b:b + n].contiguous(), f_proj[b:b + n].contiguous(),
            feats[b:b + n].contiguous(),
            None if mask is None else mask[:, b:b + n].contiguous()) + ops[4:]


def check_scan_forward(decoder, dev, dtype, B):
    """Both forms of #4/#5 at batch ``B`` against their plain versions with
    the main check's limits, and one launch against a launch per chunk of
    32 rows, bit for bit."""
    fwd_names = ("h_tops", "attn", "h0s", "c0s", "c1s")
    tag = f"B={B} {str(dtype)[6:]}"
    ops = scan_operands(decoder, dev, dtype, SEED + 30 + B, B)
    nomask = ops[:3] + (None,) + ops[4:]
    limit = SCAN_LIMIT[dtype] if dtype == torch.float32 \
        else SCAN_FWD_BF16_LIMIT
    with torch.no_grad():
        got = S.decoder_scan_cuda(*ops, residuals=True)
        got_e = S.decoder_scan_cuda(*nomask)
        ref = S.decoder_scan_plain(*ops, residuals=True)
        ref64 = S.decoder_scan_plain(*ops, residuals=True,
                                     acc_dtype=torch.float64)
        ref_e = S.decoder_scan_plain(*nomask)
        parts = [S.decoder_scan_cuda(*scan_chunk(ops, b, 32), residuals=True)
                 for b in range(0, B, 32)]
        parts_e = [S.decoder_scan_cuda(*scan_chunk(nomask, b, 32))
                   for b in range(0, B, 32)]
    torch.cuda.synchronize()
    report(f"decoder_scan {tag} train form", rel_errs(fwd_names, got, ref),
           limit, rel_errs(fwd_names, ref64, ref))
    report(f"decoder_scan {tag} eval form",
           rel_errs(fwd_names[:2], got_e, ref_e), limit)
    chunk_same(f"decoder_scan {tag} both forms", list(got) + list(got_e),
               [torch.cat(x, dim=1) for x in zip(*parts)]
               + [torch.cat(x, dim=1) for x in zip(*parts_e)])


def check_scan(decoder, dev, mutant=None):
    """Decoder-scan kernels against their plain versions at the KD shapes;
    the forward repeated REPEATS times and the backward twice, each run
    bit-identical to the first.  Returns the operands and residuals at bf16
    for the timings, and the largest absolute errors of the bf16 (main
    path) forward and backward.  ``mutant``: "fwd" or "bwd", the kernel a
    mutation run planted a fault in; only its checks run."""
    fwd_names = ("h_tops", "attn", "h0s", "c0s", "c1s")
    kept = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        ops = scan_operands(decoder, dev, dtype, SEED + 5)
        nomask = ops[:3] + (None,) + ops[4:]
        with torch.no_grad():
            got = S.decoder_scan_cuda(*ops, residuals=True)
            ref = S.decoder_scan_plain(*ops, residuals=True)
            ref64 = S.decoder_scan_plain(*ops, residuals=True,
                                         acc_dtype=torch.float64)
            got_e = S.decoder_scan_cuda(*nomask)
            ref_e = S.decoder_scan_plain(*nomask)
        torch.cuda.synchronize()
        limit = SCAN_LIMIT[dtype] if dtype == torch.float32 \
            else SCAN_FWD_BF16_LIMIT
        if mutant != "bwd":
            fwd_err = report(f"decoder_scan {tag} train form",
                             rel_errs(fwd_names, got, ref), limit,
                             rel_errs(fwd_names, ref64, ref))
            report(f"decoder_scan {tag} eval form",
                   rel_errs(fwd_names[:2], got_e, ref_e), limit)
        if mutant is None:  # no atomics, sums in a fixed order
            with torch.no_grad():
                same = all(
                    all(torch.equal(x, y) for x, y in zip(got, S.decoder_scan_cuda(
                        *ops, residuals=True)))
                    and all(torch.equal(x, y) for x, y in zip(
                        got_e, S.decoder_scan_cuda(*nomask)))
                    for _ in range(REPEATS))
            print(f"decoder_scan {tag}: {REPEATS} more runs of both forms "
                  f"bit-identical to the first: {same} "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            if not same:
                fail(f"decoder_scan {tag}: repeated runs differ")
        if mutant == "fwd":
            continue
        rng = np.random.default_rng(SEED + 6)
        dh = torch.from_numpy(rng.standard_normal(got[0].shape).astype(
            np.float32)).to(dev).to(dtype)
        da = torch.from_numpy(rng.standard_normal(got[1].shape).astype(
            np.float32)).to(dev)
        res = ops + tuple(ref)     # both sides read the same residuals
        with torch.no_grad():
            gk = S.decoder_scan_bwd_cuda(res, dh, da)
            gp = S.decoder_scan_bwd_plain(res, dh, da)
        torch.cuda.synchronize()
        bwd_err = report(f"decoder_scan_bwd {tag}", rel_errs(S.GRADS, gk, gp),
                         SCAN_LIMIT[dtype])
        if mutant is None:  # every sum in a fixed order: runs repeat bit for bit
            with torch.no_grad():
                again = S.decoder_scan_bwd_cuda(res, dh, da)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(gk, again))
            print(f"decoder_scan_bwd {tag}: a second run bit-identical to the "
                  f"first: {same} {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                fail(f"decoder_scan_bwd {tag}: a second run differs")
        if dtype == torch.bfloat16 and mutant is None:
            kept = dict(ops=ops, nomask=nomask, res=res, dh=dh, da=da,
                        fwd_err=fwd_err, bwd_err=bwd_err)
    return kept


def time_scan(kept):
    """CUDA-event medians at bf16, the KD step's compute dtype.  The
    backward whole and by stage: the recompute, the reverse chain, the
    post-loop reductions, the weight gradients."""
    ops, nomask, res, dh, da = (kept[k] for k in
                                ("ops", "nomask", "res", "dh", "da"))
    with torch.no_grad():
        t = dict(
            eval_ms=median_ms(lambda: S.decoder_scan_cuda(*nomask), 20, 3),
            train_ms=median_ms(lambda: S.decoder_scan_cuda(
                *ops, residuals=True), 20, 3),
            plain_eval_ms=median_ms(lambda: S.decoder_scan_plain(*nomask), 5, 2),
            plain_train_ms=median_ms(lambda: S.decoder_scan_plain(
                *ops, residuals=True), 5, 2),
            bwd_ms=median_ms(lambda: S.decoder_scan_bwd_cuda(res, dh, da),
                             20, 3),
            plain_bwd_ms=median_ms(lambda: S.decoder_scan_bwd_plain(
                res, dh, da), 3, 1))
        bufs = [S.decoder_scan_bwd_buffers(res, dh, da) for _ in range(28)]
        it = iter(bufs)
        for stage in (0, 1, 2):  # each chain run needs fresh carries
            t[f"bwd_stage{stage}_ms"] = median_ms(
                lambda: S.decoder_scan_bwd_stage_cuda(next(it), stage), 20, 3)
            it = iter(bufs)
        t["bwd_weights_ms"] = median_ms(
            lambda: S.decoder_scan_bwd_weights_cuda(bufs[0]), 20, 3)
    return t


def print_scan_times(t, b):
    print(f"decoder_scan T={KD_T} B={KD_B} bf16: eval form "
          f"{t['eval_ms']:.4f} ms (plain {t['plain_eval_ms']:.4f}), "
          f"train form {t['train_ms']:.4f} ms (plain "
          f"{t['plain_train_ms']:.4f})")
    print(f"decoder_scan_bwd T={KD_T} B={KD_B} bf16 residuals: "
          f"{t['bwd_ms']:.4f} ms (bound {b['bwd'][0]:.5f} by {b['bwd'][1]}) = "
          f"recompute {t['bwd_stage0_ms']:.4f} + chain "
          f"{t['bwd_stage1_ms']:.4f} + reductions {t['bwd_stage2_ms']:.4f} + "
          f"weight gradients {t['bwd_weights_ms']:.4f} (plain "
          f"{t['plain_bwd_ms']:.4f})",
          flush=True)


def scan_bounds(kept):
    """Bounds of the three scan kernels from this run's operands: bytes are
    every input read once and every output written once; operations are the
    matrix products (2 per multiply-add) plus the attention's L x E
    elementwise work, at the peak rate of their operand type (bf16 products
    forward; the backward computes in float32)."""
    ops, res = kept["ops"], kept["res"]
    T_, B, E = ops[0].shape
    Lt, H = ops[2].shape[1], ops[7].shape[1]
    macs = H * E + E * E + 4 * H * (E + H) + 4 * H * (2 * H)  # per row and step
    attn = 6 * Lt * E                                          # tanh/score/ctx
    fwd_flops = T_ * B * (2 * macs + attn)
    outs_eval = T_ * B * H * ops[0].element_size() + T_ * B * Lt * 4
    outs_train = outs_eval + T_ * B * H * (ops[0].element_size() + 8)
    in_eval = nbytes(*ops[:3], *ops[4:])
    grads = 4 * (T_ * B * E + 2 * B * Lt * E + E * H + E * E
                 + 4 * H * (E + 3 * H) + 8 * H)
    return dict(
        eval=bound_ms(in_eval + outs_eval, fwd_flops, "bf16"),
        train=bound_ms(in_eval + nbytes(ops[3]) + outs_train, fwd_flops,
                       "bf16"),
        bwd=bound_ms(nbytes(*res, kept["dh"], kept["da"]) + grads,
                     T_ * B * (3 * 2 * macs + 3 * attn), "f32"))


def beam_ancestry(rng, N, K, S, pos, table):
    """An ancestry table (N, K, S) with the identity at ``pos``: "random"
    draws every entry; "lineage" is built step by step as
    ``beam_decode_packed_kv`` builds it (each step's rows written by the
    current slots, then every slot inherits a random origin's row), so beams
    share their ancestors' prefixes; "converged" names one slot for all K
    beams at each position < pos, one distinct row a position."""
    slots = np.arange(K, dtype=np.int32)
    if table == "random":
        anc = rng.integers(0, K, (N, K, S)).astype(np.int32)
    elif table == "lineage":
        anc = np.broadcast_to(slots[None, :, None], (N, K, S)).copy()
        for t in range(pos):
            anc[:, :, t] = slots
            origin = rng.integers(0, K, (N, K))
            anc = np.take_along_axis(anc, origin[:, :, None], axis=1)
    else:
        anc = np.repeat(rng.integers(0, K, (N, 1, S)).astype(np.int32), K, 1)
    anc[:, :, pos] = slots[None]
    return anc


def beam_operands(dev, N, dtype, pos, seed, K=BEAM_K, S=BEAM_S,
                  table="random"):
    """One beam step's attention operands at the teacher's full width from a
    numpy seed: q as the first column block of a packed (R, 1, 3E)
    projection (how ``decoder_step_cached`` hands it over), a random cache
    and memory, an ancestry table (``beam_ancestry``) with the identity at
    ``pos``."""
    rng = np.random.default_rng(seed)
    H, L = BEAM_H, BEAM_L
    R, E = N * K, BEAM_H * 64

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev).to(dtype)

    anc = beam_ancestry(rng, N, K, S, pos, table)
    return dict(q=t(R, 1, 3 * E).chunk(3, dim=-1)[0],
                kv={"k": t(R, H, S, 64), "v": t(R, H, S, 64)},
                mem_kv={"k": t(N, H, L, 64), "v": t(N, H, L, 64)},
                anc=torch.from_numpy(anc).to(dev), pos=pos)


def beam_close(what, got, ref, N, K, dtype, pos):
    """Hold one beam kernel's output to its plain version's; the largest
    error."""
    if got.dtype != dtype or got.shape != (N * K, 1, 512):
        fail(f"beam {what} attention: dtype/shape contract")
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    ok = err <= BEAM_LIMIT[dtype] and top > 0.1
    print(f"beam_{what}_attention N={N} K={K} {str(dtype)[6:]} pos={pos}: "
          f"max_abs_err {err:.3e} (limit {BEAM_LIMIT[dtype]:g}), largest "
          f"value {top:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the beam {what}-attention kernel disagrees with its plain "
             "version")
    return err


def check_beam_attention(dev, mutant=False):
    """The two beam-step kernels against their plain versions at full width,
    and at the cache's last position REPEATS more runs of each kernel
    bit-identical to the first.  Ancestry tables: random ones at N=16 and
    32, pos 0, 7 and 20; lineages built as the beam search builds them; one
    converged to one slot a position; K=2*BEAM_K beams (self: two blocks a
    head, 8 + 2 beams; cross: a second group of query rows over the same
    resident K/V), and at S=64, pos=63 the self kernel's rows staged in
    chunks at float32 (the check fails if that plan has one chunk).  The
    self kernel's plan must be the one ``BA.self_plan`` computes.  Returns
    the largest errors of the main path's case (N=16, K=5, float32)."""
    main_err = {"self": 0.0, "cross": 0.0}
    both = (torch.float32, torch.bfloat16)
    cases = [(N, BEAM_K, BEAM_S, dtype, pos, SEED + 20 + pos, "random")
             for N in (BEAM_B, 2 * BEAM_B) for dtype in both
             for pos in (0, 7, BEAM_S - 1)]
    cases += [(BEAM_B, BEAM_K, BEAM_S, dtype, pos, SEED + 40 + pos, table)
              for table in ("lineage", "converged") for dtype in both
              for pos in (7, BEAM_S - 1)]
    cases += [(BEAM_B, 2 * BEAM_K, S, dtype, S - 1, SEED + 60, "random")
              for S in (BEAM_S, BA.MAX_S) for dtype in both]
    for N, K, S, dtype, pos, seed, table in cases:
        plan = BA.self_plan(K, pos, dtype)
        if BA.self_plan_built(K, pos, dtype) != plan:
            fail(f"the self kernel's plan {BA.self_plan_built(K, pos, dtype)}"
                 f" is not the wrapper's {plan}")
        if S == BA.MAX_S and dtype == torch.float32 and plan["chunks"] < 2:
            fail(f"the chunked case takes one chunk: {plan}")
        o = beam_operands(dev, N, dtype, pos, seed, K=K, S=S, table=table)
        got_s = BA.beam_self_attention_cuda(
            o["q"], o["kv"], o["anc"], pos, num_heads=BEAM_H)
        ref_s = BA.beam_self_attention_plain(
            o["q"], o["kv"], o["anc"], pos, num_heads=BEAM_H)
        got_c = BA.beam_cross_attention_cuda(
            o["q"], o["mem_kv"], mem_group=K, num_heads=BEAM_H)
        ref_c = BA.beam_cross_attention_plain(
            o["q"], o["mem_kv"], mem_group=K, num_heads=BEAM_H)
        torch.cuda.synchronize()
        print(f"beam ancestry {table} S={S}: self plan {plan}", flush=True)
        for what, got, ref in (("self", got_s, ref_s), ("cross", got_c, ref_c)):
            err = beam_close(what, got, ref, N, K, dtype, pos)
            if N == BEAM_B and K == BEAM_K and dtype == torch.float32:
                main_err[what] = max(main_err[what], err)
        if pos == S - 1 and table == "random" and not mutant:
            tag = f"N={N} K={K} S={S} {str(dtype)[6:]}"
            repeats_same(f"beam_self_attention {tag}", [got_s],
                         lambda: [BA.beam_self_attention_cuda(
                             o["q"], o["kv"], o["anc"], pos,
                             num_heads=BEAM_H)])
            repeats_same(f"beam_cross_attention {tag}", [got_c],
                         lambda: [BA.beam_cross_attention_cuda(
                             o["q"], o["mem_kv"], mem_group=K,
                             num_heads=BEAM_H)])
    return main_err


def beam_bounds(o):
    """Bounds of the two beam kernels from one step's operands.  Self: q,
    out and the live part of the ancestry table once, plus the rows of k and
    v that this table names (a row shared by several beams counts once);
    operations are the two products over positions 0..pos.  Cross: q, out
    and the whole memory K and V once."""
    q, anc, pos = o["q"], o["anc"], o["pos"]
    R, E, H, item = q.shape[0], q.shape[2], BEAM_H, q.element_size()
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    live = anc[:, :, :pos + 1].sort(dim=1).values
    rows = int((live[:, 1:] != live[:, :-1]).sum()) + live.shape[0] * (pos + 1)
    self_bytes = 2 * R * E * item + live.numel() * 4 + 2 * rows * H * 64 * item
    cross_bytes = 2 * R * E * item + nbytes(*o["mem_kv"].values())
    return dict(
        self=bound_ms(self_bytes, 4 * R * H * (pos + 1) * 64, kind),
        cross=bound_ms(cross_bytes, 4 * R * H * BEAM_L * 64, kind))


def all_slots_operands(o):
    """The self kernel's function in the form the TPU kernel computes it, as
    ``scaled_dot_product_attention`` takes it: each query (N, H, K, 64)
    scores the K slots x (pos + 1) positions of its image, keys and values
    (N, H, K * (pos + 1), 64), under a boolean mask (N, 1, K, K * (pos + 1))
    that is true where ``anc[n, i, s] == j``.  Built outside any timing."""
    q, kv, anc, pos = o["q"], o["kv"], o["anc"], o["pos"]
    N, K, _ = anc.shape
    P = pos + 1

    def slots(c):
        c = c.reshape(N, K, BEAM_H, -1, 64)[:, :, :, :P]
        return c.transpose(1, 2).reshape(N, BEAM_H, K * P, 64).contiguous()

    qh = q.reshape(N, K, BEAM_H, 64).transpose(1, 2).contiguous()
    j = torch.arange(K, device=anc.device)
    mask = (anc[:, :, None, :P] == j[None, None, :, None]).reshape(
        N, 1, K, K * P)
    return qh, slots(kv["k"]), slots(kv["v"]), mask


def time_beam_attention(dev):
    """CUDA-event medians of the two kernels, their plain versions and
    ``scaled_dot_product_attention`` on the same function (a yardstick: the
    port never calls it; for the self kernel over the all-slots form of
    ``all_slots_operands``, built before the timing), at N=16 and the loop's
    last position; float32 is the main path's dtype, bf16 is timed beside
    it.  ``self_sdpa_err`` is that yardstick's largest difference from the
    plain version."""
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        o = beam_operands(dev, BEAM_B, dtype, MAX_LEN - 1, SEED + 30)
        q, kv, mkv, anc, pos = (o[k] for k in ("q", "kv", "mem_kv", "anc",
                                               "pos"))
        qh = q.reshape(BEAM_B, BEAM_K, BEAM_H, 64).transpose(1, 2).contiguous()
        sq, sk, sv, smask = all_slots_operands(o)

        def self_sdpa():
            return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask,
                                                  scale=0.125)

        sdpa_err = (self_sdpa().transpose(1, 2).reshape(q.shape).float()
                    - BA.beam_self_attention_plain(
                        q, kv, anc, pos, num_heads=BEAM_H).float()
                    ).abs().max().item()
        out[tag] = dict(
            self_ms=median_ms(lambda: BA.beam_self_attention_cuda(
                q, kv, anc, pos, num_heads=BEAM_H), 200),
            self_plain_ms=median_ms(lambda: BA.beam_self_attention_plain(
                q, kv, anc, pos, num_heads=BEAM_H), 50),
            self_sdpa_ms=median_ms(self_sdpa, 200),
            cross_ms=median_ms(lambda: BA.beam_cross_attention_cuda(
                q, mkv, mem_group=BEAM_K, num_heads=BEAM_H), 200),
            cross_plain_ms=median_ms(lambda: BA.beam_cross_attention_plain(
                q, mkv, mem_group=BEAM_K, num_heads=BEAM_H), 50),
            cross_sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qh, mkv["k"], mkv["v"], scale=0.125), 200),
            self_queued_ms=queued_ms(lambda: BA.beam_self_attention_cuda(
                q, kv, anc, pos, num_heads=BEAM_H)),
            self_sdpa_queued_ms=queued_ms(self_sdpa),
            cross_queued_ms=queued_ms(lambda: BA.beam_cross_attention_cuda(
                q, mkv, mem_group=BEAM_K, num_heads=BEAM_H)),
            cross_sdpa_queued_ms=queued_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, mkv["k"], mkv["v"], scale=0.125)),
            self_sdpa_err=sdpa_err, bounds=beam_bounds(o))
    return out


def sharpen_teacher(params: dict) -> None:
    """Scale a random teacher in place so that beam search does all of its
    work.  At its default init the decoder barely reads the image and never
    ranks END high: no hypothesis finishes, no beam shrinks, and equal
    tokens check little.  The cross-attention's projections are scaled up
    (sharper weights over the memory tokens and a larger share of the
    residual stream: the images matter) and END gets a bias (some beams
    finish, at different steps)."""
    for layer in params["decoder"]:
        layer["multihead_attn"]["in_proj_weight"] *= BEAM_CROSS_IN_GAIN
        layer["multihead_attn"]["out_proj"]["weight"] *= BEAM_CROSS_GAIN
    params["fc_out"]["bias"][END] += BEAM_END_BIAS


def beam_images(n_batches: int, seed: int):
    """Seeded uint8 batches (BEAM_B, 224, 224, 3): every 16x16 patch a flat
    random colour plus a little noise, so that images differ from each other
    in every ViT token (a random ViT maps plain noise images to nearly one
    memory)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        blocks = rng.integers(0, 256, (BEAM_B, 14, 14, 3))
        img = np.repeat(np.repeat(blocks, 16, axis=1), 16, axis=2)
        img = img + rng.integers(-8, 9, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def write_beam_teacher(path: str) -> None:
    """A full-width teacher from the numpy seed, sharpened, as a JAX-format
    checkpoint."""
    cfg = TeacherConfig(vocab_size=VOCAB)
    params = teacher_init(SEED + 3, cfg)
    sharpen_teacher(params)
    mc = dataclasses.asdict(cfg)
    mc.pop("vocab_size")
    save_checkpoint(path, {"model_state_dict": {"params": params},
                           "vocab_size": VOCAB, "model_config": mc})


def beam_outcomes(scores: np.ndarray, lens: np.ndarray) -> dict:
    """What a run of beam search did, read from its outputs: images where no
    hypothesis finished, images that ran out of live beams before the last
    step, and the lengths at which hypotheses finished."""
    fin = np.isfinite(scores)
    return dict(
        never=int((lens == BEAM_S).all(1).sum()),
        ran_out=int((fin.all(1) & (lens.max(1) < BEAM_S)).sum()),
        finished_lens=sorted(set(lens[fin & (lens < BEAM_S)].tolist())))


def check_beam_contract(seqs, scores, lens, n):
    K, S = BEAM_K, BEAM_S
    if seqs.shape != (n, K, S) or seqs.dtype != np.int32 \
            or scores.shape != (n, K) or scores.dtype != np.float32 \
            or lens.shape != (n, K) or lens.dtype != np.int32:
        fail(f"beam outputs out of contract: {seqs.shape} {seqs.dtype}, "
             f"{scores.shape} {scores.dtype}, {lens.shape} {lens.dtype}")
    fin = np.isfinite(scores)
    if seqs.min() < 0 or seqs.max() >= VOCAB or np.isnan(scores).any() \
            or not fin[:, 0].all() or not (seqs[fin][:, 0] == START).all():
        fail("beam tokens or scores out of range")
    ranked = np.where(fin, scores, -np.inf)
    if (ranked[:, 1:] > ranked[:, :-1]).any():
        fail("beam scores are not sorted")
    if (lens[fin] < 2).any() or (lens[fin] > S).any() or (lens[~fin] != 0).any():
        fail("beam lengths out of range")


def run_beam_batches(caption, batches):
    """Per-batch host-clock seconds (each call ends in device-to-host
    copies) and the concatenated outputs."""
    caption(batches[0])                                    # warm-up
    torch.cuda.synchronize()
    A.launches = BA.launches_self = BA.launches_cross = 0
    outs, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        outs.append(caption(b))
        secs.append(time.perf_counter() - t0)
    launches = {"attention_core": A.launches,
                "beam_self_attention": BA.launches_self,
                "beam_cross_attention": BA.launches_cross}
    return secs, tuple(np.concatenate(x) for x in zip(*outs)), launches


def top_rows_identical(a, b) -> int:
    """Images whose best hypothesis has the same tokens in both results."""
    return int((np.asarray(a[0])[:, 0] == np.asarray(b[0])[:, 0]).all(1).sum())


@torch.inference_mode()
def plain_beam_on_card(teacher, memory, acc_dtype):
    """The packed beam with the two attention cores replaced by their plain
    versions on the same device, summing in ``acc_dtype``."""
    real = TD.beam_self_attention, TD.beam_cross_attention
    TD.beam_self_attention = functools.partial(
        BA.beam_self_attention_plain, acc_dtype=acc_dtype)
    TD.beam_cross_attention = functools.partial(
        BA.beam_cross_attention_plain, acc_dtype=acc_dtype)
    try:
        out = D.beam_search_teacher_packed(teacher, memory, max_length=MAX_LEN,
                                           beam_size=BEAM_K)
    finally:
        TD.beam_self_attention, TD.beam_cross_attention = real
    return tuple(t.cpu().numpy() for t in out)


def wall_ms(fn, n: int = 5):
    """Median host-clock ms of ``fn()`` between synchronisations."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run_beam(dev, tmp):
    """Teacher beam serving at full width; returns the launch counts of the
    float32 run and the rates."""
    ckpt = os.path.join(tmp, "beam_teacher.npz")
    write_beam_teacher(ckpt)
    t32, cfg = serve.load_teacher(ckpt, dev)
    t16, _ = serve.load_teacher(ckpt, dev, torch.bfloat16)
    t_cpu, _ = serve.load_teacher(ckpt, "cpu")
    batches = beam_images(BEAM_BATCHES, SEED + 11)
    kw = dict(max_length=MAX_LEN, beam_size=BEAM_K)
    n = BEAM_B * BEAM_BATCHES
    rates = {}
    for tag, teacher in (("float32", t32), ("bf16", t16)):
        caption = serve.make_beam_captioner(teacher, cfg, dev, **kw)
        secs, (seqs, scores, lens), launched = run_beam_batches(caption, batches)
        check_beam_contract(seqs, scores, lens, n)
        o = beam_outcomes(scores, lens)
        rates[tag] = n / sum(secs)
        print(f"beam path {tag}: launches {launched}; of {n} images {o['never']} "
              f"never finish, {o['ran_out']} run out of live beams early; "
              f"hypotheses finish at lengths {o['finished_lens']}; "
              f"{len({tuple(r) for r in seqs[:, 0].tolist()})} distinct best "
              f"captions", flush=True)
        print(f"beam end-to-end {tag}: {rates[tag]:.1f} images/s (B={BEAM_B} x "
              f"{BEAM_BATCHES} batches, K={BEAM_K}, T={MAX_LEN}, host clock "
              f"incl. H2D/D2H); per batch ms: median "
              f"{1e3 * statistics.median(secs):.3f}, min {1e3 * min(secs):.3f}, "
              f"max {1e3 * max(secs):.3f}", flush=True)
        if min(launched.values()) < 1:
            fail(f"a kernel of the beam path was not launched: {launched}")
        if o["never"] < 1 or o["ran_out"] < 1 or len(o["finished_lens"]) < 3:
            fail(f"the beam run has no power: {o}")
        if tag == "float32":
            launches = launched

    # float32 on the card (kernels) against the all-plain CPU path
    small = batches[1][:4]
    got = serve.make_beam_captioner(t32, cfg, dev, **kw)(small)
    ref = serve.make_beam_captioner(t_cpu, cfg, "cpu", **kw)(small)
    rows = top_rows_identical(got, ref)
    same = (got[0][:, 0] == ref[0][:, 0]).all(1)
    score_err = float(np.abs(got[1][:, 0] - ref[1][:, 0])[same].max()) \
        if same.any() else float("inf")
    ok = rows >= 3 and score_err <= 1e-4
    print(f"fp32 beam card vs CPU on 4 images: best hypothesis identical in "
          f"{rows}/4 (need 3), their scores differ by {score_err:.3e} (limit "
          f"1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's float32 beam path disagrees with the CPU reference")

    # bf16 on the card: kernels against the all-plain path, and the floor:
    # what the plain path moves when it only sums in float64
    with torch.inference_mode():
        x = torch.from_numpy(batches[2]).to(dev)
        mem16 = t16.encode_image(T.normalize(x, dtype=torch.bfloat16))
        mem32 = t32.encode_image(T.normalize(x))
        ker = tuple(t.cpu().numpy() for t in D.beam_search_teacher_packed(
            t16, mem16, **kw))
    p32 = plain_beam_on_card(t16, mem16, torch.float32)
    p64 = plain_beam_on_card(t16, mem16, torch.float64)
    rows, floor = top_rows_identical(ker, p32), top_rows_identical(p64, p32)
    need = BEAM_B - 4       # near-tied beams swap at bf16; the floor says how many
    print(f"bf16 beam kernels vs plain on the card: best hypothesis identical "
          f"in {rows}/{BEAM_B} (need {need}); plain f64-vs-f32 sums agree on "
          f"{floor}/{BEAM_B} {'ok' if rows >= need else 'FAIL'}", flush=True)
    if rows < need:
        fail("the bf16 beam kernels disagree with the plain path")

    # where a batch's time goes, pack widths, and the early-exit read
    with torch.inference_mode():
        images = T.normalize(torch.from_numpy(
            np.concatenate(batches[:2])).to(dev))
        mem_big = t32.encode_image(images)
        split = dict(
            encode_ms=wall_ms(lambda: t32.encode_image(images[:BEAM_B])),
            decode_ms=wall_ms(lambda: D.beam_search_teacher_packed(
                t32, mem32, **kw)),
            decode_no_exit_ms=wall_ms(lambda: D.beam_search_teacher_packed(
                t32, mem32, early_exit=False, **kw)))
        for pack in (8, 16, 32):
            split[f"pack{pack}_ms"] = wall_ms(
                lambda: D.beam_search_teacher_pipelined(t32, mem_big, pack=pack,
                                                        **kw), 3)
    print(f"beam batch float32 B={BEAM_B}: encode {split['encode_ms']:.3f} ms, "
          f"memory K/V + decode loop {split['decode_ms']:.3f} ms (without the "
          f"early-exit read {split['decode_no_exit_ms']:.3f} ms); 32 images "
          f"decoded in packs of 8 / 16 / 32: {split['pack8_ms']:.3f} / "
          f"{split['pack16_ms']:.3f} / {split['pack32_ms']:.3f} ms (host "
          f"clock, synchronised, medians)", flush=True)
    return launches, rates, split


def pad_vocabulary(vocab, size):
    """Fill the grid vocabulary up to the serving point's size."""
    for i in range(len(vocab), size):
        vocab.itos[i] = f"tok{i}"
        vocab.stoi[f"tok{i}"] = i
    return vocab


def kd_counters(variant):
    """The launch counts of a variant's KD path, by kernel name."""
    counts = {"attention_core": A.launches}
    if variant == "full":
        counts.update(decoder_scan=S.launches_eval,
                      decoder_scan_train=S.launches_train,
                      decoder_scan_bwd=S.launches_bwd)
    elif variant == "compact":
        counts.update(compact_scan=S.launches_compact)
    else:
        counts.update(enhanced_scan=ES.launches)
    return counts


def zero_counters():
    A.launches = G.launches = G.launches_compact = ES.launches = 0
    S.launches_eval = S.launches_train = S.launches_bwd = 0
    S.launches_compact = 0
    BA.launches_self = BA.launches_cross = 0


def run_kd(dev, tmp, variant="full"):
    """The training path at full width through
    ``train_student_with_kd_on_loaders`` on the in-memory grid data;
    returns (launch counts, trained state, student config, teacher
    checkpoint path, train loader)."""
    train_loader, val_loader, vocab = make_grid_loaders(
        KD_IMAGES, image_size=224, seed=SEED, batch_size=KD_B,
        max_caption_len=KD_T + 1)
    pad_vocabulary(vocab, VOCAB)
    t_cfg = TeacherConfig(vocab_size=VOCAB)
    mc = dataclasses.asdict(t_cfg)
    mc.pop("vocab_size")
    ckpt = os.path.join(tmp, "teacher.npz")
    save_checkpoint(ckpt, {
        "model_state_dict": {"params": teacher_init(SEED + 3, t_cfg)},
        "vocab_size": VOCAB, "model_config": mc})
    out = os.path.join(tmp, f"kd_out_{variant}")
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state, s_cfg, _ = TK.train_student_with_kd_on_loaders(
        train_loader, val_loader, vocab, ckpt, out, num_epochs=1,
        compute_dtype=torch.bfloat16, seed=SEED, device=dev, verbose=False,
        student_variant=variant, data_parallel=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kd_counters(variant)
    print(f"KD path ({variant}) launches: {launches} ({wall:.1f} s for the preflight, "
          f"{KD_STEPS} optimizer steps of {KD_A} x {KD_B} images, the "
          f"validation pass and two checkpoints)", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the KD path was not launched: {launches}")
    if state.opt_state.step != KD_STEPS:
        fail(f"the trainer took {state.opt_state.step} steps, not {KD_STEPS}")

    final = load_checkpoint(os.path.join(out, "final_student_model.npz"))
    hist = json.load(open(os.path.join(out, "student_training_history.json")))
    numbers = [*hist["train_losses"], *hist["val_losses"],
               *(v for vs in hist["loss_components"].values() for v in vs)]
    print(f"KD history ({variant}): train loss {hist['train_losses']}, val loss "
          f"{hist['val_losses']}, components "
          f"{ {k: v[0] for k, v in hist['loss_components'].items()} }")
    if not numbers or not np.isfinite(numbers).all():
        fail(f"a KD metric is not finite: {hist}")
    if int(final["optimizer_state_dict"]["step"]) != KD_STEPS:
        fail("the final checkpoint does not carry the optimizer step")

    # parameters of every group the variant has moved, frozen ones did not
    # (the compact student has no refinement: its "others" are the projectors)
    p0, s0 = student_init(SEED, s_cfg)
    start = CV.jax_student_to_state_dict(p0, s0, s_cfg)
    moved, frozen = moved_groups(state.student, start)
    first_bn = next(n for n, _ in state.student.named_buffers()
                    if n.endswith("running_mean"))
    stats_moved = not torch.equal(
        dict(state.student.named_buffers())[first_bn].cpu(), start[first_bn])
    print(f"KD parameters moved per group: {moved}; {frozen} frozen ones did "
          f"not; frozen batch-norm statistics ({first_bn}) updated: "
          f"{stats_moved}", flush=True)
    if frozen < 1:
        fail("no parameter of the backbone is frozen")
    if min(moved.values()) < 1 or not stats_moved:
        fail("a parameter group did not move")
    return launches, state, s_cfg, ckpt, train_loader


def time_kd_steps(dev, state, s_cfg, ckpt, train_loader, n=4):
    """Wall time of further optimizer steps on the trained state (host clock
    around each step, ending in a synchronise)."""
    teacher, t_cfg = TK.load_teacher(ckpt, VOCAB, dev)
    step = steps.make_kd_train_step(teacher, t_cfg, s_cfg, DistillConfig(),
                                    KDTrainConfig(),
                                    compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    stacks = list(common.stacked_batches(train_loader, KD_A))
    times = []
    for i in range(n + 1):
        batch = steps.batch_to_device(stacks[i % len(stacks)], dev)
        torch.cuda.synchronize()
        if i == 1:
            zero_counters()
        t0 = time.perf_counter()
        metrics = step(state, batch, 0.5, gen)
        float(metrics["total_loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_step = {k: v / n for k, v in kd_counters(s_cfg.variant).items()}
    print(f"KD step ({s_cfg.variant}) kernel launches per step: {per_step}",
          flush=True)
    return times[1:]    # the first repeats the warm-up of a fresh generator


def card_vs_cpu_step(dev, s_cfg, ckpt, train_loader):
    """One float32 KD step on the card (kernels) against the same step on
    the CPU (plain versions): dropout off, augmentation off, A=1, B=4."""
    cfg0 = dataclasses.replace(s_cfg, dropout=0.0)
    p0, s0 = student_init(SEED, cfg0)
    proj, _ = create_feature_projectors(
        SEED + 1, teacher_embed=TeacherConfig().embed_size,
        student_embed=cfg0.embed_size, student_hidden=cfg0.hidden_size)
    stacked = next(iter(common.stacked_batches(train_loader, 1)))
    small = {"images": stacked["images"][:, :4],
             "captions": stacked["captions"][:, :, :4],
             "lengths": stacked["lengths"][:, :4]}
    results = {}
    t_embed = TeacherConfig().embed_size
    for where in (dev, torch.device("cpu")):
        student = Student(cfg0)
        student.load_state_dict(CV.jax_student_to_state_dict(p0, s0, cfg0),
                                strict=True)
        projectors = make_projectors(t_embed, cfg0.embed_size,
                                     cfg0.hidden_size)
        projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                                   strict=True)
        teacher, t_cfg = TK.load_teacher(ckpt, VOCAB, where)
        state = steps.init_train_state(student.to(where),
                                       projectors.to(where), cfg0)
        step = steps.make_kd_train_step(
            teacher, t_cfg, cfg0, DistillConfig(), KDTrainConfig(dropout=0.0),
            aug=T.AugmentConfig(), compute_dtype=torch.float32)
        before = kd_counters(s_cfg.variant)
        before.pop("decoder_scan", None)   # the eval form: not in a train step
        with M.no_dropout():
            metrics = step(state, steps.batch_to_device(small, where), 0.0,
                           None)
        results[where.type] = {k: float(v) for k, v in metrics.items()}
        after = kd_counters(s_cfg.variant)
        launched = {k: after[k] - n for k, n in before.items()}
        if where.type == "cuda" and min(launched.values()) < 1:
            fail(f"the float32 card step missed a kernel: {launched}")
        if where.type == "cpu" and any(launched.values()):
            fail("the CPU step launched a kernel")
    return results


# Limits of the float32 card-vs-CPU step, relative.  Loss terms: the forward
# passes differ only in summation order (cuDNN and cuBLAS against the CPU's
# kernels, this repository's kernels against their plain versions).  The
# gradient norm gathers a ResNet-50 backward through train-mode batch norm
# at random weights, which amplifies float32 noise far more than the forward.
CARD_CPU_LOSS_LIMIT = 1e-4
CARD_CPU_GNORM_LIMIT = 1e-3


# ---------------------------------------------------------------------------
# The compact and the enhanced student
# ---------------------------------------------------------------------------

ENH_L, ENH_NH, ENH_E, ENH_H = 64, SE.NUM_HEADS, 384, 768
# Limits of the enhanced scan.  Its three LayerNorms re-scale whatever
# rounding the state carries, so the recurrence drifts faster than the other
# two: at float32 the plain version itself moves 3e-5 of the largest value
# when it only sums in float64, and at bf16, where three layers' h are
# rounded to 8 bits at every step, its largest deviation grows from 0.016
# at step 1 to 0.2 at step 46 (5% of the largest value) while the mean stays
# under 1%.  So the float32 limit is on the largest error, and the bf16
# limits are on the mean absolute error over the mean absolute value, each
# printed beside the plain version's own float64-against-float32 floor.
ENH_F32_LIMIT = 5e-4
ENH_BF16_MEAN_LIMIT = 2e-2
ENH_BF16_GRAD_MEAN_LIMIT = 5e-2


def sharpen_compact_decoder(dec: dict) -> None:
    """``sharpen_decoder`` for the compact decoder (dot attention, a linear
    head on h).  With the head scaled up and features drawn per row, 29 rows
    of 32 decode to their own tokens and 5 end within two steps, so END ->
    PAD and the frozen token run; two plain bf16 decodes that differ only in
    summation precision agree on all 32 rows.  An LSTM gain of 2 as well
    puts bf16 into chaos (28 of 32)."""
    dec["output_projection"]["weight"] *= 32.0
    dec["output_projection"]["bias"][END] += 1.5


def sharpen_enhanced_decoder(dec: dict) -> None:
    """``sharpen_decoder`` for the enhanced decoder: with features drawn per
    row every row decodes to its own tokens and rows end at different
    steps."""
    for layer in dec["lstm"]:
        layer["weight_ih"] *= 2.0
        layer["weight_hh"] *= 2.0
    for fc in ("fc1", "fc2"):
        dec["output_projection"][fc]["weight"] *= 4.0
    dec["output_projection"]["fc2"]["bias"][END] += 4.0


SHARPEN = {"full": sharpen_decoder, "compact": sharpen_compact_decoder,
           "enhanced": sharpen_enhanced_decoder}


def token_power(ref, B, what):
    """A token comparison only has power if rows differ and END occurs."""
    distinct = len({tuple(r) for r in ref.tolist()})
    ended = int((ref == PAD).any(dim=1).sum())
    if distinct < B // 2 or not 0 < ended < B:
        fail(f"{what} check has no power: {distinct} distinct rows, "
             f"{ended} of {B} rows end")
    return distinct, ended


def compact_greedy_inputs(dev):
    """The sharpened full-width compact decoder of the serving path (the
    same weights ``write_student`` puts in its checkpoint) and features
    drawn per row."""
    cfg = compact_student_config(VOCAB)
    params, _ = student_init(SEED, cfg)
    sharpen_compact_decoder(params["decoder"])
    decoder = L.CompactDecoder(cfg)
    decoder.load_state_dict(CV.tree_to_state_dict(params["decoder"]),
                            strict=True)
    feats32 = seeded(np.random.default_rng(SEED + 2),
                     (BATCH, cfg.feature_tokens, cfg.embed_size), dev)
    return decoder.to(dev), feats32


def check_greedy_compact(decoder, feats32, mutant=False, timed=True):
    """Kernel #3 against its plain version at full width (L=49, E=H=256,
    V=2994, T=20; B=32 on the main path): float32 token-identical, bf16 in
    all rows but one in 32 (the floor, two plain decodes that differ in
    summation precision, is printed beside it); then the same call REPEATS
    times, which must repeat bit for bit (a race in the cross-block
    exchange shows there).  Returns (max |token diff| at float32, fewest
    bf16 rows identical, kernel ms, plain ms, the bf16 operands), the times
    only when ``timed``."""
    B = feats32.shape[0]
    max_diff, bf16_rows = 0, B
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype).contiguous()
        w = G.greedy_compact_operands(decoder, dtype)
        for temp in (1.0, 2.0):
            kw = dict(max_length=MAX_LEN, temperature=temp)
            got = G.greedy_decode_compact_cuda(w, feats, **kw)
            ref = G.greedy_decode_compact_plain(w, feats, **kw)
            ref64 = G.greedy_decode_compact_plain(w, feats, **kw,
                                                  acc_dtype=torch.float64)
            torch.cuda.synchronize()
            distinct, ended = token_power(ref, B, "compact greedy")
            rows = int((got == ref).all(dim=1).sum())
            floor = int((ref64 == ref).all(dim=1).sum())
            need = B if dtype == torch.float32 else B - -(-B // 32)
            print(f"greedy_decode_compact B={B} {str(dtype)[6:]} T={temp}: "
                  f"{rows}/{B} rows identical (need {need}; plain f64-vs-f32 "
                  f"sums agree on {floor}); reference has {distinct} distinct "
                  f"rows, {ended} ending {'ok' if rows >= need else 'FAIL'}",
                  flush=True)
            if rows < need:
                fail("compact greedy kernel disagrees with its plain version")
            if dtype == torch.float32:
                max_diff = max(max_diff,
                               int((got.long() - ref.long()).abs().max()))
            else:
                bf16_rows = min(bf16_rows, rows)
        if not mutant:
            repeats_same(f"greedy_decode_compact B={B} {str(dtype)[6:]}",
                         [got], lambda: [G.greedy_decode_compact_cuda(
                             w, feats, **kw)])
    if mutant or not timed:
        return max_diff, bf16_rows, None, None, (w, feats)
    kms = median_ms(lambda: G.greedy_decode_compact_cuda(
        w, feats, max_length=MAX_LEN), 20, 3)
    pms = median_ms(lambda: G.greedy_decode_compact_plain(
        w, feats, max_length=MAX_LEN), 10, 2)
    return max_diff, bf16_rows, kms, pms, (w, feats)


def greedy_compact_bound(w, feats):
    B, Lt, E = feats.shape
    H, V = w["w_hh"].shape[1], w["emb"].shape[0]
    macs = E * H + 4 * H * (E + H) + V * H + 2 * Lt * E
    return bound_ms(nbytes(feats, *w.values()) + B * MAX_LEN * 4,
                    2 * macs * B * MAX_LEN, "bf16")


def seeded(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(dev).to(dtype)


def function_grads(fn, ops, cots, skip=()):
    """Gradients that ``fn`` gives its floating operands (those at ``skip``
    excepted) for the cotangents ``cots`` on its first outputs."""
    leaves = [o.detach().clone().requires_grad_(True)
              if o is not None and o.is_floating_point() and i not in skip
              else o for i, o in enumerate(ops)]
    outs = fn(*leaves)[:len(cots)]
    sum((o.float() * c.float()).sum() for o, c in zip(outs, cots)).backward()
    return [(i, x.grad) for i, x in enumerate(leaves)
            if x is not None and x.requires_grad]


def check_gradients(what, dtype, fn, plain, bwd_plain, ops, ref, ref64, n_out,
                    dev, skip=(), limits=None, mean=False):
    """The gradients of ``fn`` (a forward kernel under autograd, its
    backward the plain reverse-time loop over the kernel's residuals), for
    random cotangents on its first ``n_out`` outputs.  At float32 against
    autograd through ``plain``, the plain forward: both sides are float32
    arithmetic in another order.  At bf16 autograd rounds the gradient to 8
    bits wherever the forward rounds h, which the float32 reverse-time loop
    does not, so there the reference is the same loop over the plain
    forward's residuals ``ref`` (``bwd_plain(ops + ref, *cots)``), beside
    the floor: that loop over ``ref64``, the plain forward summed in
    float64."""
    rng = np.random.default_rng(SEED + 8)
    cots = [seeded(rng, r.shape, dev, r.dtype) for r in ref[:n_out]]
    got = function_grads(fn, ops, cots, skip)
    pick = lambda gs: [(i, g) for i, g in enumerate(gs) if g is not None]  # noqa: E731
    floor = None
    if dtype == torch.float32:
        want = function_grads(plain, ops, cots, skip)
    else:
        with torch.no_grad():
            want = pick(bwd_plain(ops + tuple(ref), *cots))
            low = pick(bwd_plain(ops + tuple(x.to(r.dtype) for x, r in
                                             zip(ref64, ref)), *cots))
        floor = rel_errs(range(len(want)), [g for _, g in low],
                         [g for _, g in want], mean)
    torch.cuda.synchronize()
    if [i for i, _ in got] != [i for i, _ in want]:
        fail(f"{what}: gradients for other operands than the reference's")
    rows = rel_errs([f"operand {i}" for i, _ in want], [g for _, g in got],
                    [g for _, g in want], mean)
    limits = limits or {torch.float32: SCAN_LIMIT[torch.float32],
                        torch.bfloat16: SCAN_FWD_BF16_LIMIT}
    return report(what, rows, limits[dtype], floor, mean, brief=True)


def compact_scan_operands(decoder, dev, dtype, seed, B=KD_B):
    """The seven operands of the compact scan at the KD shapes (or batch
    ``B``), prepared as ``compact_decoder_apply`` prepares them."""
    rng = np.random.default_rng(seed)
    cfg = compact_student_config(VOCAB)
    feats = seeded(rng, (B, cfg.feature_tokens, cfg.embed_size), dev, dtype,
                   0.3)
    caps = torch.from_numpy(rng.integers(0, VOCAB, (KD_T, B))).to(dev)
    with torch.no_grad():
        emb = decoder.embedding(caps).to(dtype).contiguous()
        weights = L.compact_scan_weights(decoder, dtype)
    return (emb, feats.contiguous()) + tuple(w.detach() for w in weights)


def check_compact_scan(decoder, dev, mutant=False):
    """Kernel #7 against its plain version at the KD shapes (T=47, B=16,
    L=49, E=H=256): h, attn and c, float32 and bf16, and REPEATS more runs
    bit-identical to the first; then the kernel under autograd (plain
    reverse-time backward over the kernel's residuals) against autograd
    through the plain forward.  A mutation run checks the forward only."""
    names = ("hs", "attn", "cs")
    kept = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        ops = compact_scan_operands(decoder, dev, dtype, SEED + 12)
        with torch.no_grad():
            got = S.compact_scan_cuda(*ops)
            ref = S.compact_scan_plain(*ops)
            ref64 = S.compact_scan_plain(*ops, acc_dtype=torch.float64)
        torch.cuda.synchronize()
        limit = SCAN_LIMIT[dtype] if dtype == torch.float32 \
            else SCAN_FWD_BF16_LIMIT
        err = report(f"compact_scan {tag}", rel_errs(names, got, ref), limit,
                     rel_errs(names, ref64, ref))
        if mutant:
            continue
        repeats_same(f"compact_scan {tag}", got,
                     lambda: S.compact_scan_cuda(*ops))
        before = S.launches_compact
        check_gradients(
            f"compact_scan {tag} gradient", dtype, S._CompactScan.apply,
            S.compact_scan_plain, S.compact_scan_bwd_plain, ops, ref, ref64,
            2, dev)
        if S.launches_compact != before + 1:
            fail("the compact scan under autograd did not launch its kernel")
        if dtype == torch.bfloat16:
            kept = dict(ops=ops, err=err)
    if mutant:
        return kept
    ops = kept["ops"]
    with torch.no_grad():
        kept["ms"] = median_ms(lambda: S.compact_scan_cuda(*ops), 20, 3)
        kept["plain_ms"] = median_ms(lambda: S.compact_scan_plain(*ops), 5, 2)
        res = ops + S.compact_scan_cuda(*ops)
        dh, da = torch.ones_like(res[7]), torch.ones_like(res[8])
        kept["bwd_plain_ms"] = median_ms(
            lambda: S.compact_scan_bwd_plain(res, dh, da), 3, 1)
    T_, B, E = ops[0].shape
    Lt, H = ops[1].shape[1], ops[5].shape[1]
    outs = T_ * B * (H * ops[0].element_size() + 4 * H + 4 * Lt)
    kept["bound"] = bound_ms(
        nbytes(*ops) + outs,
        T_ * B * (2 * (E * H + 4 * H * (E + H)) + 4 * Lt * E), "bf16")
    return kept


COMPACT_GREEDY_BATCHES = (40, 5)  # #3 at two chunks (32 + 8 rows) and one odd chunk
COMPACT_SCAN_BATCHES = (24, 5)    # #7 at two chunks (16 + 8 rows) and one odd chunk


def check_compact_batches(g_decoder, s_decoder, dev):
    """#3 at the batches of COMPACT_GREEDY_BATCHES and #7 at those of
    COMPACT_SCAN_BATCHES, which the main path's shapes (B=32, B=16) do not
    reach: each held against its plain version with the main check's
    limits, and a launch of several chunks equal to separate launches of
    each chunk (32 rows for #3, 16 for #7), bit for bit."""
    for B in COMPACT_GREEDY_BATCHES:
        feats32 = seeded(np.random.default_rng(SEED + 20 + B),
                         (B, 49, g_decoder.embedding.weight.shape[1]), dev)
        with torch.inference_mode():
            check_greedy_compact(g_decoder, feats32, timed=False)
            for dtype in (torch.float32, torch.bfloat16):
                feats = feats32.to(dtype).contiguous()
                w = G.greedy_compact_operands(g_decoder, dtype)
                whole = G.greedy_decode_compact_cuda(w, feats,
                                                     max_length=MAX_LEN)
                parts = torch.cat([G.greedy_decode_compact_cuda(
                    w, feats[b:b + 32].contiguous(), max_length=MAX_LEN)
                    for b in range(0, B, 32)])
                chunk_same(f"greedy_decode_compact B={B} {str(dtype)[6:]}",
                           [whole], [parts])
    names = ("hs", "attn", "cs")
    for B in COMPACT_SCAN_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"B={B} {str(dtype)[6:]}"
            ops = compact_scan_operands(s_decoder, dev, dtype, SEED + 30 + B,
                                        B)
            cut = lambda b: (ops[0][:, b:b + 16].contiguous(),  # noqa: E731
                             ops[1][b:b + 16].contiguous()) + ops[2:]
            with torch.no_grad():
                got = S.compact_scan_cuda(*ops)
                ref = S.compact_scan_plain(*ops)
                ref64 = S.compact_scan_plain(*ops, acc_dtype=torch.float64)
                parts = [S.compact_scan_cuda(*cut(b)) for b in range(0, B, 16)]
            torch.cuda.synchronize()
            report(f"compact_scan {tag}", rel_errs(names, got, ref),
                   SCAN_LIMIT[dtype] if dtype == torch.float32
                   else SCAN_FWD_BF16_LIMIT, rel_errs(names, ref64, ref),
                   brief=True)
            chunk_same(f"compact_scan {tag}", list(got),
                       [torch.cat(x, dim=1) for x in zip(*parts)])


def make_variant_decoder(variant, dev):
    """A full-width decoder of a variant at its default init from the numpy
    seed."""
    cfg = STUDENT_CONFIGS[variant](VOCAB)
    cls = {"compact": L.CompactDecoder, "enhanced": SE.EnhancedDecoder}[variant]
    decoder = cls(cfg)
    decoder.load_state_dict(CV.tree_to_state_dict(
        cls.init(np.random.default_rng(SEED + 4), cfg)), strict=True)
    return decoder.to(dev)


def enhanced_scan_operands(decoder, dev, dtype, seed, masked, B=KD_B):
    """The 29 operands of the enhanced scan at the KD shapes (T=47, B=16,
    L=64, E=384, H=768; or batch ``B``), as ``enhanced_decoder_apply``
    prepares them, with seeded dropout multipliers (rates 0.1 and 0.15) or
    none."""
    rng = np.random.default_rng(seed)
    cfg = enhanced_student_config(VOCAB)
    feats = seeded(rng, (B, ENH_L, cfg.embed_size), dev, dtype)
    caps = torch.from_numpy(rng.integers(0, VOCAB, (KD_T, B))).to(dev)
    masks = None
    if masked:
        ka, kl = 1.0 - SE.ATTN_DROPOUT, 1.0 - cfg.dropout
        masks = {
            "attn": torch.from_numpy(
                (rng.random((KD_T, B, ENH_NH, ENH_L)) < ka) / ka).float(
                ).to(dev),
            "lstm": torch.from_numpy(
                (rng.random((3, KD_T, B, cfg.hidden_size)) < kl) / kl
                ).float().to(dev),
            "proj": torch.ones(KD_T, B, cfg.embed_size, dtype=torch.bool,
                               device=dev)}
    seen = {}
    real = ES.enhanced_decoder_scan
    ES.enhanced_decoder_scan = lambda *ops: seen.update(ops=ops) or \
        ES.enhanced_scan_plain(*ops)[:3]
    try:
        with torch.no_grad():
            SE.enhanced_decoder_apply(decoder, feats, caps, cfg,
                                      train=masked, masks=masks)
    finally:
        ES.enhanced_decoder_scan = real
    return tuple(None if o is None else o.detach() for o in seen["ops"])


def check_enhanced_scan(decoder, dev, mutant=False):
    """Kernel #8 against its plain version at the KD shapes, with and
    without dropout multipliers, float32 and bf16, all eight outputs, and
    REPEATS more runs of each bit-identical to the first; then the kernel
    under autograd (plain reverse-time backward over the kernel's
    residuals) against autograd through the plain forward, masked."""
    kept = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        mean = dtype == torch.bfloat16
        limit = ENH_BF16_MEAN_LIMIT if mean else ENH_F32_LIMIT
        for masked in (True, False):
            ops = enhanced_scan_operands(decoder, dev, dtype, SEED + 13, masked)
            with torch.no_grad():
                got = ES.enhanced_scan_cuda(*ops)
                ref = ES.enhanced_scan_plain(*ops)
                ref64 = ES.enhanced_scan_plain(*ops, acc_dtype=torch.float64)
            torch.cuda.synchronize()
            report(f"enhanced_scan {tag} "
                   f"{'with' if masked else 'without'} masks",
                   rel_errs(ES.OUTPUTS, got, ref, mean), limit,
                   rel_errs(ES.OUTPUTS, ref64, ref, mean), mean)
            if not mutant:  # no atomics, sums in a fixed order
                repeats_same(f"enhanced_scan {tag} "
                             f"{'with' if masked else 'without'} masks", got,
                             lambda: ES.enhanced_scan_cuda(*ops))
            worst = lambda a, b: max(  # noqa: E731
                e for _, e, _ in rel_errs(ES.OUTPUTS, a, b))
            if masked and not mean:
                f32_err, f32_ops = worst(got, ref), ops
            if masked and mean:
                kept = dict(ops=ops, err=worst(got, ref), f32_err=f32_err,
                            f32_ops=f32_ops, floor=worst(ref64, ref))
            if masked and not mutant:
                before = ES.launches
                check_gradients(
                    f"enhanced_scan {tag} gradient", dtype,
                    ES._EnhancedScan.apply, ES.enhanced_scan_plain,
                    ES.enhanced_scan_bwd_plain, ops, ref, ref64, 3, dev,
                    skip=(4, 5), mean=mean,
                    limits={torch.float32: ENH_F32_LIMIT,
                            torch.bfloat16: ENH_BF16_GRAD_MEAN_LIMIT})
                if ES.launches != before + 1:
                    fail("the enhanced scan under autograd did not launch "
                         "its kernel")
    return kept


def repeats_same(what, first, run):
    """REPEATS more runs of ``run`` must equal ``first`` bit for bit."""
    with torch.no_grad():
        same = all(all(torch.equal(x, y) for x, y in zip(first, run()))
                   for _ in range(REPEATS))
    print(f"{what}: {REPEATS} more runs bit-identical to the first: {same} "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail(f"{what}: repeated runs differ")


ENH_BATCHES = (4, 24)  # #8 at a padded tile and at two chunks (16 + 8 rows)


def enhanced_chunk(ops, b, n):
    """The enhanced scan operands of batch rows [b, b + n): embp, gate_w
    and amask are (T, B, ·), k and v (B, ·), lmask (3, T, B, H)."""
    embp, gate_w, k, v, amask, lmask = ops[:6]
    cut = lambda x, *lead: None if x is None else \
        x[lead + (slice(b, b + n),)].contiguous()  # noqa: E731
    return (cut(embp, slice(None)), cut(gate_w, slice(None)), cut(k),
            cut(v), cut(amask, slice(None)),
            cut(lmask, slice(None), slice(None))) + ops[6:]


def check_enhanced_batches(decoder, dev):
    """#8 at the batches of ENH_BATCHES, which the KD path (B=16) does not
    reach, masked, both dtypes, against its plain version with the main
    check's limits; and one launch against a launch per chunk of 16 rows,
    bit for bit."""
    for B in ENH_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            tag, mean = f"B={B} {str(dtype)[6:]}", dtype == torch.bfloat16
            ops = enhanced_scan_operands(decoder, dev, dtype, SEED + 40 + B,
                                         True, B)
            with torch.no_grad():
                got = ES.enhanced_scan_cuda(*ops)
                ref = ES.enhanced_scan_plain(*ops)
                ref64 = ES.enhanced_scan_plain(*ops, acc_dtype=torch.float64)
                parts = [ES.enhanced_scan_cuda(*enhanced_chunk(ops, b, 16))
                         for b in range(0, B, 16)]
            torch.cuda.synchronize()
            report(f"enhanced_scan {tag} with masks",
                   rel_errs(ES.OUTPUTS, got, ref, mean),
                   ENH_BF16_MEAN_LIMIT if mean else ENH_F32_LIMIT,
                   rel_errs(ES.OUTPUTS, ref64, ref, mean), mean, brief=True)
            chunk_same(f"enhanced_scan {tag}", list(got),
                       [torch.cat(x, dim=1) for x in zip(*parts)])


def time_enhanced_scan(kept):
    ops = kept["ops"]
    with torch.no_grad():
        kept["ms"] = median_ms(lambda: ES.enhanced_scan_cuda(*ops), 10, 2)
        kept["f32_ms"] = median_ms(
            lambda: ES.enhanced_scan_cuda(*kept["f32_ops"]), 5, 1)
        kept["plain_ms"] = median_ms(lambda: ES.enhanced_scan_plain(*ops), 3, 1)
        res = ops + ES.enhanced_scan_cuda(*ops)
        cots = [torch.ones_like(res[29 + i]) for i in range(3)]
        kept["bwd_plain_ms"] = median_ms(
            lambda: ES.enhanced_scan_bwd_plain(res, *cots), 3, 1)
    T_, B, E = ops[0].shape
    H = ops[6 + ES.WEIGHTS.index("whh0")].shape[1]
    item = ops[0].element_size()
    outs = T_ * B * (4 * H * item + 3 * H * 4 + ENH_L * 4)
    macs = sum(o.numel() for o, n in zip(ops[6:], ES.WEIGHTS)
               if n not in ES._FLOAT32_WEIGHTS) + 2 * ENH_L * E
    kept["bound"] = bound_ms(nbytes(*ops) + outs, 2 * macs * T_ * B, "bf16")
    return kept


def check_attention_48(dev, gen):
    """Kernel #2 at the enhanced cross refinement's shape (B=16, 8 heads,
    Lq = Lk = 64, hd = 384 / 8 = 48), against plain in all four type
    pairings; returns the bf16 error."""
    shape = (KD_B, ENH_NH, ENH_L, 48)
    scale = 48 ** -0.5
    for qk_dt, v_dt in ATTN_DTYPES:
        q, k = (torch.randn(shape, device=dev, generator=gen).to(qk_dt)
                for _ in range(2))
        v = torch.randn(shape, device=dev, generator=gen).to(v_dt)
        got = A.attention_core_cuda(q, k, v, scale=scale)
        ref = A.attention_core_plain(q, k, v, scale=scale)
        torch.cuda.synchronize()
        e = (got.float() - ref.float()).abs().max().item()
        ok = e <= ATTN_LIMIT[v_dt] and got.dtype == v_dt
        print(f"attention_core {shape} q,k {str(qk_dt)[6:]} v {str(v_dt)[6:]}"
              f": max_abs_err {e:.3e} (limit {ATTN_LIMIT[v_dt]:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("attention kernel disagrees with its plain version at hd=48")
        if qk_dt == v_dt == torch.bfloat16:
            err = e
    try:
        A.attention_core_cuda(q[..., :40].contiguous(), k[..., :40].contiguous(),
                              v[..., :40].contiguous(), scale=scale)
    except ValueError:
        pass
    else:
        fail("the attention wrapper took a head dimension it has no kernel for")
    return err


def write_student(tmp, variant, vocab_path=None):
    """A full-width student of ``variant`` from the numpy seed, its decoder
    sharpened, as a JAX-format checkpoint; returns the path."""
    cfg = STUDENT_CONFIGS[variant](VOCAB)
    params, state = student_init(SEED, cfg)
    SHARPEN[variant](params["decoder"])
    path = os.path.join(tmp, f"student_{variant}.npz")
    save_checkpoint(path, {
        "student_state_dict": {"params": params, "model_state": state},
        "vocab_size": VOCAB,
        "model_config": dict(
            embed_size=cfg.embed_size, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers, dropout=cfg.dropout,
            use_attention_refinement=cfg.use_attention_refinement,
            model_type=variant)})
    return path


def serve_variant(dev, ckpt, batches, variant, counters):
    """The serving path of a variant at full width in bf16: the serve
    loader, ``make_greedy_captioner`` over 8 batches of 32 images; then the
    float32 card path against the all-plain CPU path on 4 images.
    ``counters()`` reads the launch counts the path must raise.  Returns
    (launch counts, images/s, per-batch seconds, the float32 model)."""
    model32, _ = serve.load_student(ckpt, dev, torch.float32)
    model16, cfg = serve.load_student(ckpt, dev, torch.bfloat16)
    model_cpu, _ = serve.load_student(ckpt, "cpu", torch.float32)
    if cfg.variant != variant:
        fail(f"the checkpoint loaded as {cfg.variant}, not {variant}")
    caption = serve.make_greedy_captioner(model16, cfg, dev, max_length=MAX_LEN)
    caption(batches[0])                                   # warm-up
    torch.cuda.synchronize()
    zero_counters()
    tokens, batch_s = [], []
    for b in batches:      # each call ends in a device-to-host copy
        t0 = time.perf_counter()
        tokens.append(caption(b))
        batch_s.append(time.perf_counter() - t0)
    launches = counters()
    print(f"{variant} serving path launches: {launches}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the {variant} serving path was not launched: "
             f"{launches}")
    toks = np.concatenate(tokens)
    if toks.shape != (BATCH * len(batches), MAX_LEN) or toks.dtype != np.int32 \
            or toks.min() < 0 or toks.max() >= VOCAB:
        fail(f"{variant} tokens out of contract: {toks.shape} {toks.dtype}")
    rate = BATCH * len(batches) / sum(batch_s)
    print(f"{variant} end-to-end: {rate:.1f} images/s (bf16, B={BATCH} x "
          f"{len(batches)} batches, T={MAX_LEN}, host clock incl. H2D/D2H); "
          f"per batch ms: median {1e3 * statistics.median(batch_s):.3f}, "
          f"min {1e3 * min(batch_s):.3f}, max {1e3 * max(batch_s):.3f}",
          flush=True)

    small = batches[1][:4]
    with torch.inference_mode():
        fg = model32.encode_image(T.normalize(torch.from_numpy(small).to(dev))
                                  )[1].cpu()
        fc = model_cpu.encode_image(T.normalize(torch.from_numpy(small)))[1]
    feat_err = (fg - fc).abs().max().item()
    tg = serve.make_greedy_captioner(model32, cfg, dev)(small)
    tc = serve.make_greedy_captioner(model_cpu, cfg, "cpu")(small)
    rows = int((tg == tc).all(axis=1).sum())
    ok = np.isfinite(fg.numpy()).all() and feat_err <= 1e-3 and rows >= 3
    print(f"{variant} fp32 card vs CPU on 4 images: refined max_abs_err "
          f"{feat_err:.3e} (limit 1e-3), {rows}/4 caption rows identical "
          f"(need 3) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the card's float32 {variant} path disagrees with the CPU "
             "reference")
    return launches, rate, batch_s, model32


def check_enhanced_loop(model32, dev):
    """The enhanced student's serving loop has no kernel of its own, so its
    check with power is the loop itself: float32 on the card against the
    CPU on features drawn per row (every row its own tokens, rows ending at
    different steps)."""
    cfg = model32.cfg
    feats = seeded(np.random.default_rng(SEED + 2), (BATCH, ENH_L,
                                                     cfg.embed_size), "cpu")
    cpu = Student(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model32.state_dict().items()})
    ref = D.greedy_decode_student(cpu.eval(), feats, cfg, max_length=MAX_LEN)
    got = D.best_greedy_decode_student(model32, feats.to(dev), cfg,
                                       max_length=MAX_LEN).cpu()
    distinct, ended = token_power(ref, BATCH, "enhanced greedy loop")
    rows = int((got == ref).all(dim=1).sum())
    print(f"enhanced greedy loop fp32 card vs CPU B={BATCH}: {rows}/{BATCH} "
          f"rows identical (need {BATCH - 1}); reference has {distinct} "
          f"distinct rows, {ended} ending "
          f"{'ok' if rows >= BATCH - 1 else 'FAIL'}", flush=True)
    if rows < BATCH - 1:
        fail("the enhanced greedy loop on the card disagrees with the CPU")


def run_variant_kd(dev, tmp, variant):
    """3 optimizer steps of ``train_student_with_kd_on_loaders`` at full width, a few
    timed steps, and one float32 step card against CPU, for a variant.
    Returns (launch counts, images/s, per-step seconds)."""
    launches, state, s_cfg, ckpt, loader = run_kd(dev, tmp, variant)
    step_s = time_kd_steps(dev, state, s_cfg, ckpt, loader)
    rate = KD_A * KD_B / statistics.median(step_s)
    print(f"KD step ({variant}): {rate:.1f} images/s (bf16 compute, float32 "
          f"teacher, A={KD_A} x B={KD_B}, T={KD_T}, host clock incl. H2D); "
          f"per step ms: median {1e3 * statistics.median(step_s):.3f}, min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}", flush=True)
    compare_card_cpu(card_vs_cpu_step(dev, s_cfg, ckpt, loader), variant)
    return launches, rate, step_s


def compare_card_cpu(both, variant):
    for k in common.LOSS_NAMES + ("grad_norm",):
        g, c = both["cuda"][k], both["cpu"][k]
        rel = abs(g - c) / max(abs(c), 1e-12) if c else abs(g)
        limit = CARD_CPU_GNORM_LIMIT if k == "grad_norm" else CARD_CPU_LOSS_LIMIT
        ok = np.isfinite(g) and rel <= limit
        print(f"fp32 KD step ({variant}) card vs CPU {k}: {g:.7g} vs {c:.7g}, "
              f"relative {rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"the card's float32 {variant} KD step disagrees with the "
                 "CPU's")


# ---------------------------------------------------------------------------
# The disk pipeline: CSV/PPM dataset -> trainer -> resume -> evaluators
# ---------------------------------------------------------------------------

DISK_IMAGES, DISK_CAPTIONS, DISK_MISSING = 96, 5, 2   # Flickr8k: 5 per image
DISK_SIZE, DISK_STEPS, DISK_MAX_WORDS = 224, 3, 46     # 46 words: T = 47


def write_disk_dataset(root: str) -> str:
    """96 grid images as binary PPM under ``root/Images`` and a
    ``captions_clean.csv`` of 5 rows an image plus 2 rows naming missing
    files, whose vocabulary at the trainer's threshold (5) has exactly
    ``VOCAB`` tokens: each caption is the image's grid caption followed by
    filler words, every filler word used 5 times.  Returns the CSV path."""
    images, grid_caps = make_grid_dataset(DISK_IMAGES, image_size=DISK_SIZE,
                                          seed=SEED + 21)
    os.makedirs(os.path.join(root, "Images"))
    names = [f"img_{i:04d}.ppm" for i in range(DISK_IMAGES)]
    for name, im in zip(names, images):
        write_ppm(os.path.join(root, "Images", name), im)
    rows = [(n, c) for n, c in zip(names, grid_caps)
            for _ in range(DISK_CAPTIONS)]
    rows += [(f"missing_{i}.ppm", "") for i in range(DISK_MISSING)]
    grid_words = {w for c in grid_caps for w in c.split()}
    fill = [f"w{i:04d}" for i in range(VOCAB - len(SPECIALS) - len(grid_words))]
    tokens = fill * 5
    per_row = -(-len(tokens) // len(rows))
    lines = ["image,caption"]
    for k, (name, cap) in enumerate(rows):
        words = cap.split() + tokens[k * per_row:(k + 1) * per_row]
        lines.append(f"{name},{' '.join(words)}")
    csv_path = os.path.join(root, "captions_clean.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    ds = CaptionDataset(root, csv_path)
    longest = max(len(c.split()) for c in ds.captions)
    if len(ds.vocab) != VOCAB or longest > DISK_MAX_WORDS:
        fail(f"the disk dataset has V={len(ds.vocab)} (want {VOCAB}) and "
             f"captions of up to {longest} words (want <= {DISK_MAX_WORDS})")
    return csv_path


def loader_rates(root: str, csv_path: str) -> dict:
    """Rows a second of the loader's cold epoch (PPM decode in the thread
    pool) and warm epoch (the RAM cache), batches of 16, host clock."""
    loader = BatchLoader(CaptionDataset(root, csv_path, image_size=DISK_SIZE),
                         batch_size=KD_B, shuffle=False)
    rates = {}
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        n = sum(len(b["lengths"]) for b in loader)
        rates[tag] = n / (time.perf_counter() - t0)
    return rates


def moved_groups(student, reference: dict) -> tuple:
    """Trainable parameters that moved from ``reference``, counted by group
    (encoder, decoder, others), and the frozen ones that did not move."""
    moved, frozen = {"encoder": 0, "decoder": 0}, 0
    for name, q in student.named_parameters():
        same = torch.equal(q.detach().cpu(), reference[name])
        if not q.requires_grad:
            frozen += 1
            if not same:
                fail(f"frozen parameter {name} moved")
            continue
        group = name.split(".")[0]
        group = group if group in moved else "others"
        moved[group] = moved.get(group, 0) + int(not same)
    return moved, frozen


def metric_records(path: str) -> list:
    recs = [json.loads(line) for line in open(path).read().splitlines()]
    if not all(np.isfinite([v for k, v in r.items() if k != "epoch"]).all()
               for r in recs):
        fail(f"a per-step metric record is not finite: {recs}")
    return recs


def finite_numbers(report, where: str) -> int:
    """Fail on a non-finite number anywhere in a report; count the None
    ratios (a zero denominator) to print them."""
    nones = 0
    stack = [report]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif x is None:
            nones += 1
        elif isinstance(x, (int, float)) and not math.isfinite(x):
            fail(f"{where} holds a non-finite number: {x}")
    return nones


def check_reports(student_rep: dict, teacher_rep: dict, n_student: int,
                  n_teacher: int) -> None:
    """Every image captioned by both models in both reports (no failure is
    absorbed by the per-image fallback), finite numbers throughout."""
    failures = {m: round(n_student * (1 - student_rep[m]["success_rate"]))
                for m in ("student", "teacher")}
    failures["teacher report"] = teacher_rep["num_samples"] - n_teacher
    rates = [student_rep[m]["success_rate"] for m in ("student", "teacher")]
    rates.append(teacher_rep["success_rate"])
    nones = finite_numbers(student_rep, "the comparison report") \
        + finite_numbers(teacher_rep, "the teacher report")
    s, t = student_rep["student"], student_rep["teacher"]
    print(f"disk evaluators: failures {failures}, success rates {rates}; "
          f"student BLEU-1 {s['bleu1']:.4f} METEOR {s['meteor']:.4f}, teacher "
          f"BLEU-1 {t['bleu1']:.4f} METEOR {t['meteor']:.4f}; summary "
          f"{student_rep['summary']} ({nones} ratios None: a zero "
          f"denominator)", flush=True)
    if any(failures.values()) or rates != [1.0, 1.0, 1.0] \
            or student_rep["num_samples"] != n_student:
        fail("an evaluator lost an image to its per-image fallback")
    if not (s["avg_inference_time_s"] and t["avg_inference_time_s"]):
        fail("the comparison report has no latency")


def check_evaluator_rows(dev, tmp, root, csv_path, vocab_path) -> None:
    """Float32 rows on a sharpened student and teacher (written as the
    serving phases write them): the batched greedy kernel (B=16) against
    the per-image one (B=1) on 8 images, the packed beam against the
    per-image beam on 4, and the card's report captions against the same
    evaluator on the CPU (all plain versions) on 4 images."""
    s_ckpt, t_ckpt = write_student(tmp, "full"), os.path.join(tmp, "bt.npz")
    write_beam_teacher(t_ckpt)
    ev = EVS.load_student_evaluator(s_ckpt, t_ckpt, vocab_path, device=dev)
    ds = CaptionDataset(root, csv_path, vocab=ev.vocab, image_size=DISK_SIZE)
    images = EVT.to_images(np.stack([ds.load_image(DISK_CAPTIONS * i)
                                    for i in range(KD_B)]), dev, torch.float32)
    batched = ev.student_captions_batch(images)
    single = [ev.student_caption(images[i:i + 1]) for i in range(8)]
    packed = ev.teacher_captions_batch(images[:4])
    beams = [ev.teacher_caption(images[i:i + 1]) for i in range(4)]
    ds.select([DISK_CAPTIONS * i for i in range(4)])
    kw = dict(max_samples=4, measure_latency_samples=0, verbose=False)
    card = ev.compare_models_on_dataset(ds, **kw)["comparisons"]
    cpu = EVS.load_student_evaluator(s_ckpt, t_ckpt, vocab_path, device="cpu"
                                    ).compare_models_on_dataset(ds, **kw)
    agree = {m: sum(a[m] == b[m] for a, b in zip(card, cpu["comparisons"]))
             for m in ("student", "teacher")}
    distinct = {"student": len(set(batched)), "teacher": len(set(packed))}
    ok = (batched[:8] == single and packed == beams
          and min(agree.values()) >= 3 and min(distinct.values()) > 1)
    print(f"disk evaluator rows fp32: greedy B=16 vs B=1 "
          f"{sum(a == b for a, b in zip(batched, single))}/8 identical, "
          f"packed vs per-image beam "
          f"{sum(a == b for a, b in zip(packed, beams))}/4, card vs CPU "
          f"report captions {agree} of 4 (need 3); distinct captions "
          f"{distinct}; e.g. student {batched[0][:60]!r}, teacher "
          f"{packed[0][:60]!r} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the evaluators' captions disagree across batch sizes or with "
             "the CPU, or have no power")


def run_disk_pipeline(dev, tmp, smi):
    """The disk pipeline at full width: a Flickr8k-shaped CSV/PPM dataset,
    ``train_student_with_kd(data_root, ...)`` for 3 steps with the metric
    log, a resume for a second epoch, and both evaluators on the trained
    student.  Returns the launch counts of its three runs and its times."""
    root = os.path.join(tmp, "flickr")
    csv_path = write_disk_dataset(root)
    rates = loader_rates(root, csv_path)
    t_ckpt = os.path.join(tmp, "teacher.npz")
    t_cfg = TeacherConfig(vocab_size=VOCAB)
    mc = dataclasses.asdict(t_cfg)
    mc.pop("vocab_size")
    save_checkpoint(t_ckpt, {
        "model_state_dict": {"params": teacher_init(SEED + 3, t_cfg)},
        "vocab_size": VOCAB, "model_config": mc})
    out, log = os.path.join(tmp, "disk_out"), os.path.join(tmp, "m.jsonl")
    kw = dict(num_epochs=1, max_steps_per_epoch=DISK_STEPS, metrics_jsonl=log,
              compute_dtype=torch.bfloat16, seed=SEED, device=dev,
              verbose=False, data_parallel=False, image_size=DISK_SIZE)

    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    state, s_cfg, vocab = TK.train_student_with_kd(root, csv_path, t_ckpt,
                                                   out, **kw)
    best = os.path.join(out, "best_student_model.npz")
    landed = os.path.exists(best)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = kd_counters("full")
    recs = metric_records(log)
    hist = json.load(open(os.path.join(out, "student_training_history.json")))
    numbers = [*hist["train_losses"], *hist["val_losses"],
               *(v for vs in hist["loss_components"].values() for v in vs)]
    print(f"disk train: V={len(vocab)}, {len(recs)} metric records, step "
          f"{state.opt_state.step}, best checkpoint landed {landed}, launches "
          f"{train}; train loss {hist['train_losses']}, val loss "
          f"{hist['val_losses']} ({train_s:.2f} s with the preflight, "
          f"{DISK_STEPS} steps of {KD_A} x {KD_B}, the validation pass over "
          f"30 batches and the checkpoints)", flush=True)
    if min(train.values()) < 1:
        fail(f"a kernel of the disk training run was not launched: {train}")
    if state.opt_state.step != DISK_STEPS or len(recs) != DISK_STEPS \
            or not landed or not numbers or not np.isfinite(numbers).all() \
            or len(vocab) != VOCAB:
        fail("the disk training run did not take its steps, log them, land "
             "its best checkpoint or keep its history finite")

    ck = load_checkpoint(best)
    sd = ck["student_state_dict"]
    at_best = CV.jax_student_to_state_dict(sd["params"], sd["model_state"],
                                           s_cfg)
    zero_counters()
    t0 = time.perf_counter()
    state, _, _ = TK.train_student_with_kd(
        root, csv_path, t_ckpt, os.path.join(tmp, "disk_resumed"),
        resume_from=best, **dict(kw, num_epochs=2))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume = kd_counters("full")
    new = metric_records(log)[DISK_STEPS:]
    moved, frozen = moved_groups(state.student, at_best)
    print(f"disk resume: from step {int(ck['optimizer_state_dict']['step'])} "
          f"at epoch {int(ck['epoch'])} to step {state.opt_state.step}; new "
          f"records at epochs {sorted({r['epoch'] for r in new})}, steps "
          f"{[r['step'] for r in new]}; moved per group {moved}, {frozen} "
          f"frozen ones equal the checkpoint's; launches {resume} "
          f"({resume_s:.2f} s)", flush=True)
    if int(ck["optimizer_state_dict"]["step"]) != DISK_STEPS \
            or state.opt_state.step != 2 * DISK_STEPS or len(new) != DISK_STEPS \
            or any(r["epoch"] != 1 for r in new) or min(moved.values()) < 1 \
            or frozen < 1 or min(resume[k] for k in resume
                                 if k != "decoder_scan") < 1:
        fail("the resumed run did not go on from the checkpoint")

    vocab_path = os.path.join(out, "vocab.json")
    ev = EVS.load_student_evaluator(best, t_ckpt, vocab_path, device=dev)
    ds = CaptionDataset(root, csv_path, vocab=ev.vocab, image_size=DISK_SIZE)
    torch.cuda.synchronize()
    zero_counters()
    student_rep = ev.generate_comparison_report(
        ds, os.path.join(tmp, "student_vs_teacher_report.json"),
        max_samples=2 * KD_B, eval_batch=KD_B, measure_latency_samples=2,
        verbose=False)
    teacher_rep = EVT.load_teacher_evaluator(t_ckpt, vocab_path, device=dev
                                            ).generate_report(
        ds, os.path.join(tmp, "evaluation_report.json"), max_samples=KD_B,
        verbose=False)
    evaluate = {"greedy_decode": G.launches, "attention_core": A.launches,
                "beam_self_attention": BA.launches_self,
                "beam_cross_attention": BA.launches_cross}
    print(f"disk evaluators launches: {evaluate}", flush=True)
    if min(evaluate.values()) < 1:
        fail(f"a kernel of the evaluators was not launched: {evaluate}")
    check_reports(student_rep, teacher_rep, 2 * KD_B, KD_B)
    check_evaluator_rows(dev, tmp, root, csv_path, vocab_path)
    times = dict(train_s=train_s, resume_s=resume_s,
                 student_latency_s=student_rep["student"]["avg_inference_time_s"],
                 teacher_latency_s=student_rep["teacher"]["avg_inference_time_s"],
                 loader_cold_images_per_s=rates["cold"],
                 loader_warm_images_per_s=rates["warm"])
    print(f"disk pipeline times ({smi}): train {train_s:.3f} s, resume "
          f"{resume_s:.3f} s; evaluator latency a image: student "
          f"{1e3 * times['student_latency_s']:.3f} ms, teacher "
          f"{1e3 * times['teacher_latency_s']:.3f} ms (float32, B=1, host "
          f"clock to tokens on the host); loader {rates['cold']:.1f} images/s "
          f"cold (PPM decode), {rates['warm']:.1f} warm (cache), batches of "
          f"{KD_B}", flush=True)
    return {"train": train, "resume": resume, "evaluate": evaluate}, times


# ---------------------------------------------------------------------------
# Teacher training: CSV/PPM dataset -> train_teacher.train -> resume -> beam
# ---------------------------------------------------------------------------

# TeacherTrainConfig defaults: A=3 micro-batches of B=12; 3 steps an epoch
TEACH_A, TEACH_B, TEACH_STEPS = 3, 12, 3
TEACH_CPU_B = 2       # images of the float32 card-vs-CPU step


@contextlib.contextmanager
def recording_teacher_steps(records: list):
    """Record every teacher train step the trainer makes: its epoch time,
    its metrics, the optimizer step it started from, and the learning rate
    each lr group got from ``adamw_update``; for a step that started from a
    restored optimizer (step > 0) the first moments it started from, on
    the host."""
    real_make, real_update = steps.make_teacher_train_step, O.adamw_update
    rates = {}

    def update(grads, state, params, *, lr_fn, lr_scale, trainable, **kw):
        for scale in {lr_scale[n] for n in params if trainable[n]}:
            rates[scale] = lr_fn(scale)
        return real_update(grads, state, params, lr_fn=lr_fn,
                           lr_scale=lr_scale, trainable=trainable, **kw)

    def make(*args, **kw):
        step = real_make(*args, **kw)

        def recorded(state, batch, sched_t, gen):
            rec = dict(sched_t=sched_t, step_before=state.opt_state.step)
            if rec["step_before"] and not any(r["step_before"]
                                              for r in records):
                rec["mu_before"] = {n: m.cpu().clone()
                                    for n, m in state.opt_state.mu.items()}
            rates.clear()
            metrics = step(state, batch, sched_t, gen)
            rec.update(metrics, rates=dict(rates))
            records.append(rec)
            return metrics

        return recorded

    steps.make_teacher_train_step, O.adamw_update = make, update
    try:
        yield
    finally:
        steps.make_teacher_train_step, O.adamw_update = real_make, real_update


def check_teacher_records(records, tr, n_steps, epoch, steps_per_epoch):
    """Finite losses and gradient norms; epoch time ``epoch + idx /
    steps_per_epoch``; the encoder's rate cosine(lr x 0.1) down to the
    unscaled eta_min, the rest cosine(lr).  The two readings of the
    encoder's rate agree at a restart (t = 0) and differ everywhere else:
    at every other step it must not be 0.1 x cosine(lr)."""
    def cos(t, base):
        return O.cosine_warm_restarts(t, base_lr=base, t0=tr.sched_t0,
                                      t_mult=tr.sched_t_mult,
                                      eta_min=tr.sched_eta_min)
    numbers = [float(r[k]) for r in records for k in ("loss", "grad_norm")]
    times = [r["sched_t"] for r in records]
    want_t = [epoch + i / steps_per_epoch for i in range(n_steps)]
    enc = tr.encoder_lr_scale
    rates_ok = all(
        r["rates"] == {enc: cos(r["sched_t"], tr.learning_rate * enc),
                       1.0: cos(r["sched_t"], tr.learning_rate)}
        and (r["sched_t"] == 0
             or r["rates"][enc] != enc * cos(r["sched_t"], tr.learning_rate))
        for r in records) and any(r["sched_t"] > 0 for r in records)
    if len(records) != n_steps or not np.isfinite(numbers).all() \
            or not np.allclose(times, want_t, rtol=0, atol=1e-12) \
            or not rates_ok:
        fail(f"teacher steps: {len(records)} of {n_steps}, epoch times "
             f"{times} (want {want_t}), losses and norms {numbers}, rates "
             f"{[r['rates'] for r in records]}")
    return numbers


def teacher_groups(teacher, init: dict) -> tuple:
    """Trainable parameters that moved from ``init``, by group (the ViT's
    last 4 blocks, the norms of its frozen blocks, its final norm, the
    projection, the embedding, the decoder, the output norm and head); the
    frozen ones, each of which must equal ``init`` bit for bit."""
    depth = teacher.cfg.encoder_depth
    moved, frozen = {}, 0
    for name, q in teacher.named_parameters():
        same = torch.equal(q.detach().cpu(), init[name])
        if not q.requires_grad:
            frozen += 1
            if not same:
                fail(f"frozen teacher parameter {name} moved")
            continue
        parts = name.split(".")
        group = parts[0]
        if name.startswith("encoder.blocks."):
            group = ("encoder.last_blocks" if int(parts[2]) >= depth - 4
                     else "encoder.frozen_block_norms")
        elif name.startswith("encoder.norm."):
            group = "encoder.norm"
        moved[group] = moved.get(group, 0) + int(not same)
    return moved, frozen


def teacher_card_vs_cpu(dev, root, csv_path):
    """One float32 teacher step on the card (kernels) against the same step
    on the CPU (plain versions): dropout off, augmentation off, A=1, B=2 of
    the disk dataset's images, full width."""
    cfg = TeacherConfig(vocab_size=VOCAB, dropout=0.0, image_size=DISK_SIZE)
    p0 = teacher_init(SEED, cfg)
    loader, _ = TT.get_loader(root, csv_path, batch_size=TEACH_CPU_B,
                              max_caption_len=KD_T + 1, shuffle=False,
                              image_size=DISK_SIZE)
    batch = next(iter(common.stacked_batches(loader, 1)))
    tr = TeacherTrainConfig(accumulation_steps=1)
    per_step = cfg.encoder_depth + 2 * cfg.num_decoder_layers
    results = {}
    for where in (dev, torch.device("cpu")):
        teacher = TM.Teacher(cfg)
        teacher.load_state_dict(CV.jax_teacher_to_state_dict(p0), strict=True)
        state = steps.init_teacher_train_state(teacher.to(where), cfg)
        step = steps.make_teacher_train_step(cfg, tr, aug=T.AugmentConfig(),
                                             compute_dtype=torch.float32)
        before = A.launches
        metrics = step(state, steps.batch_to_device(batch, where), 0.0, None)
        results[where.type] = {k: float(v) for k, v in metrics.items()}
        launched = A.launches - before
        if launched != (per_step if where.type == "cuda" else 0):
            fail(f"the float32 teacher step on {where} launched #2 "
                 f"{launched} times")
    for k, limit in (("loss", CARD_CPU_LOSS_LIMIT),
                     ("grad_norm", CARD_CPU_GNORM_LIMIT)):
        g, c = results["cuda"][k], results["cpu"][k]
        rel = abs(g - c) / abs(c)
        ok = np.isfinite(g) and rel <= limit
        print(f"fp32 teacher step card vs CPU {k}: {g:.7g} vs {c:.7g}, "
              f"relative {rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("the card's float32 teacher step disagrees with the CPU's")
    return results


def time_teacher_steps(dev, state, t_cfg, root, csv_path, n=4):
    """Further bf16 steps on the trained state: host clock around each step
    (ending in a synchronise) and CUDA events around it; #2's launches a
    step; the plain backward of #2 at the ViT's training shape (one ViT
    block's share of the step's backward), per call and queued behind a
    full stream (``queued_ms``: the card's time, not the host's)."""
    tr = TeacherTrainConfig()
    step = steps.make_teacher_train_step(t_cfg, tr,
                                         compute_dtype=torch.bfloat16)
    loader, _ = TT.get_loader(root, csv_path, batch_size=TEACH_B,
                              max_caption_len=KD_T + 1, shuffle=False,
                              image_size=DISK_SIZE)
    stacks = list(itertools.islice(common.stacked_batches(loader, TEACH_A),
                                   3))
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    wall, span_ms = [], []
    for i in range(n + 1):
        batch = steps.batch_to_device(stacks[i % len(stacks)], dev)
        torch.cuda.synchronize()
        if i == 1:
            zero_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch, 0.5, gen)
        end.record()
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
    per_step = A.launches / n
    shape = (TEACH_B, t_cfg.encoder_heads, t_cfg.num_tokens,
             t_cfg.encoder_dim // t_cfg.encoder_heads)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bwd, bwd_queued = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, g = (torch.randn(shape, device=dev, generator=gen).to(dt)
                      for _ in range(4))

        def grads():
            return A.attention_core_grads(q, k, v, g, scale=shape[3] ** -0.5)
        bwd[str(dt)[6:]] = median_ms(grads, 20)
        # 8 calls: their enqueueing (about 1 ms each) stays inside the
        # blocking product's time, so the stream does not run dry
        bwd_queued[str(dt)[6:]] = queued_ms(grads, 8)
    out = dict(wall_ms=statistics.median(wall[1:]),
               span_ms=statistics.median(span_ms[1:]),
               wall_ms_all=wall[1:], span_ms_all=span_ms[1:],
               attention_launches_per_step=per_step,
               plain_backward_ms_bf16=bwd["bfloat16"],
               plain_backward_ms_f32=bwd["float32"],
               plain_backward_queued_ms_bf16=bwd_queued["bfloat16"],
               plain_backward_queued_ms_f32=bwd_queued["float32"])
    print(f"teacher step bf16 A={TEACH_A} x B={TEACH_B} T={KD_T}: wall "
          f"{out['wall_ms']:.3f} ms (host clock, synchronised), span "
          f"{out['span_ms']:.3f} ms (CUDA events around the step, idle gaps "
          f"included) median of {n}; #2 {per_step:g} launches a step; #2's "
          f"plain backward at {shape} a ViT block: {bwd['bfloat16']:.4f} ms "
          f"bf16, {bwd['float32']:.4f} ms float32 per call, "
          f"{bwd_queued['bfloat16']:.4f} / {bwd_queued['float32']:.4f} ms "
          f"queued", flush=True)
    if per_step != TEACH_A * t_cfg.encoder_depth:
        fail(f"the teacher step launched #2 {per_step} times, not "
             f"{TEACH_A * t_cfg.encoder_depth}")
    return out


def run_teacher_training(dev, tmp, root, csv_path):
    """The teacher trainer at full width on the disk dataset: 3 steps of
    A=3 x B=12 (bf16, ``TEACHER_TRAIN_AUG``, dropout 0.15), a validation
    pass, best and final checkpoints; a resume from the best for one more
    epoch; beam serving of the final checkpoint; the float32 step card
    against CPU; the step's times.  Returns the launch counts and times."""
    tr = TeacherTrainConfig()
    kw = dict(max_caption_len=KD_T + 1, image_size=DISK_SIZE,
              compute_dtype=torch.bfloat16, seed=SEED,
              max_steps_per_epoch=TEACH_STEPS, data_parallel=False,
              verbose=False, device=dev)
    rows = len(CaptionDataset(root, csv_path))
    val_batches, per_epoch = rows // TEACH_B, max(rows // TEACH_B // TEACH_A, 1)
    out = os.path.join(tmp, "teacher_out")
    records = []
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with recording_teacher_steps(records):
        state, t_cfg, vocab = TT.train(root, csv_path, out, num_epochs=1,
                                       **kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = {"attention_core": A.launches}
    depth, layers = t_cfg.encoder_depth, t_cfg.num_decoder_layers
    want = TEACH_STEPS * TEACH_A * depth + val_batches * (depth + 2 * layers)
    numbers = check_teacher_records(records, tr, TEACH_STEPS, 0, per_epoch)
    best = os.path.join(out, "best_teacher_model.npz")
    hist = json.load(open(os.path.join(out, "training_history.json")))
    init = CV.jax_teacher_to_state_dict(teacher_init(SEED, t_cfg))
    moved, frozen = teacher_groups(state.teacher, init)
    print(f"teacher train: V={len(vocab)}, {len(records)} steps, losses and "
          f"gradient norms {numbers}, rates {[r['rates'] for r in records]}; "
          f"history {hist}; moved per group {moved}, {frozen} frozen ones "
          f"equal their initial values; #2 launches {train} (want {want}: "
          f"{TEACH_A * depth} a step, {depth + 2 * layers} a validation batch "
          f"x {val_batches}); {train_s:.2f} s", flush=True)
    if train["attention_core"] != want or frozen != 4 + 8 * (depth - 4) \
            or len(moved) != 8 or min(moved.values()) < 1 \
            or not os.path.exists(best) or len(vocab) != VOCAB \
            or not np.isfinite(hist["train_losses"] + hist["val_losses"]).all():
        fail("the teacher training run did not take its steps, launch #2 as "
             "expected, freeze and move what it should, or land its "
             "checkpoints")

    ck = load_checkpoint(best)
    saved_mu = CV.tree_to_state_dict(ck["optimizer_state_dict"]["mu"])
    at_best = CV.jax_teacher_to_state_dict(ck["model_state_dict"]["params"])
    records.clear()
    zero_counters()
    t0 = time.perf_counter()
    with recording_teacher_steps(records):
        state, _, _ = TT.train(root, csv_path, os.path.join(tmp, "resumed"),
                               num_epochs=2, resume_from=best, **kw)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume = {"attention_core": A.launches}
    check_teacher_records(records, tr, TEACH_STEPS, int(ck["epoch"]) + 1,
                          per_epoch)
    first = records[0]
    same_mu = set(first.get("mu_before", {})) == set(saved_mu) and all(
        torch.equal(first["mu_before"][n], saved_mu[n]) for n in saved_mu)
    moved, frozen = teacher_groups(state.teacher, at_best)
    print(f"teacher resume: from step {int(ck['optimizer_state_dict']['step'])}"
          f" at epoch {int(ck['epoch'])}: first step at epoch time "
          f"{first['sched_t']} from optimizer step {first['step_before']}, "
          f"its first moments the checkpoint's bit for bit: {same_mu}; to "
          f"step {state.opt_state.step}; moved per group {moved}; #2 "
          f"launches {resume} ({resume_s:.2f} s)", flush=True)
    if first["step_before"] != TEACH_STEPS or not same_mu \
            or state.opt_state.step != 2 * TEACH_STEPS \
            or resume["attention_core"] != TEACH_STEPS * TEACH_A * depth \
            or min(moved.values()) < 1:
        fail("the resumed teacher run did not go on from the checkpoint")

    final = os.path.join(tmp, "resumed", "final_teacher_model.npz")
    teacher, cfg = serve.load_teacher(final, dev)
    zero_counters()
    seqs, scores, lens = serve.make_beam_captioner(
        teacher, cfg, dev, max_length=MAX_LEN, beam_size=BEAM_K)(
        beam_images(1, SEED + 31)[0])
    check_beam_contract(seqs, scores, lens, BEAM_B)
    beam = {"attention_core": A.launches, "beam_self_attention":
            BA.launches_self, "beam_cross_attention": BA.launches_cross}
    print(f"trained teacher beam-served: {BEAM_B} images, "
          f"{len({tuple(r) for r in seqs[:, 0].tolist()})} distinct best "
          f"captions, launches {beam}", flush=True)
    if min(beam.values()) < 1:
        fail(f"a kernel of the trained teacher's beam path was not launched: "
             f"{beam}")
    del teacher
    both = teacher_card_vs_cpu(dev, root, csv_path)
    times = time_teacher_steps(dev, state, t_cfg, root, csv_path)
    times.update(train_s=train_s, resume_s=resume_s)
    return {"train": train, "resume": resume, "beam": beam}, times, both


# ---------------------------------------------------------------------------
# The optimized KD trainer on the disk dataset, then the runners' twins
# ---------------------------------------------------------------------------

# OptimizedKDTrainConfig defaults: A=2 micro-batches of B=16; 3 steps an epoch
OPT_STEPS, OPT_EPOCHS = 3, 2
OPT_HOST = DISK_SIZE + 32        # training images read 32 pixels larger
OPT_CPU_B = 4                    # images of the float32 card-vs-CPU step
# Limits of the float32 optimized step card against CPU, relative.  The
# compact student's MobileNetV2 and the teacher sum in another order on the
# card; its batch norms amplify that noise in the gradient norm.
OPT_CARD_CPU_LOSS_LIMIT = 1e-5
OPT_CARD_CPU_GNORM_LIMIT = 1e-3


def onecycle_f64(step: float, max_lr: float, total: int) -> float:
    """torch OneCycleLR's cosine annealing (pct_start 0.1, div_factor 10,
    final_div_factor 100) in float64, written out apart from the port's."""
    up = 0.1 * total - 1.0
    if step <= up:
        start, end, pct = max_lr / 10.0, max_lr, step / max(up, 1.0)
    else:
        start, end = max_lr, max_lr / 1000.0
        pct = (step - up) / max(total - 1.0 - up, 1.0)
    pct = min(max(pct, 0.0), 1.0)
    return end + (start - end) * (1.0 + math.cos(math.pi * pct)) / 2.0


@contextlib.contextmanager
def recording_kd_steps(records: list):
    """Record every KD train step a trainer makes: its optimizer step
    (``sched_t``), epoch, metrics, the optimizer step it started from, the
    rate and weight decay of each group (from ``adamw_update``), its
    launches of #7 and #2; and for the first step that starts from a
    restored optimizer, the first moments it started from, on the host."""
    real_make, real_update = steps.make_kd_train_step, O.adamw_update
    groups = {}

    def update(grads, state, params, *, lr_fn, lr_scale, weight_decay,
               trainable, **kw):
        for n in params:
            if trainable[n]:
                groups[lr_scale[n]] = (lr_fn(lr_scale[n]), weight_decay[n])
        return real_update(grads, state, params, lr_fn=lr_fn,
                           lr_scale=lr_scale, weight_decay=weight_decay,
                           trainable=trainable, **kw)

    def make(*args, **kw):
        step = real_make(*args, **kw)

        def recorded(state, batch, sched_t, gen, epoch=0):
            rec = dict(sched_t=sched_t, epoch=epoch,
                       step_before=state.opt_state.step)
            if rec["step_before"] and not any(r["step_before"]
                                              for r in records):
                rec["mu_before"] = {n: m.cpu().clone()
                                    for n, m in state.opt_state.mu.items()}
            groups.clear()
            before = (S.launches_compact, A.launches)
            metrics = step(state, batch, sched_t, gen, epoch)
            rec.update({k: float(v) for k, v in metrics.items()},
                       groups=dict(groups),
                       compact_scan=S.launches_compact - before[0],
                       attention_core=A.launches - before[1])
            records.append(rec)
            return metrics

        return recorded

    steps.make_kd_train_step, O.adamw_update = make, update
    try:
        yield
    finally:
        steps.make_kd_train_step, O.adamw_update = real_make, real_update


def check_optimized_records(records, tr, od, n_steps, first_step, epochs,
                            total):
    """Finite terms; at epoch 0 the total is the token loss alone (the
    feature and hidden terms weigh 0), after it beta x epoch / 3 of the
    feature loss joins; each group's rate the float64 OneCycle of its
    scale at the step's global step, and its weight decay; #7 twice a step
    (one forward a micro-batch)."""
    bad = []
    for i, r in enumerate(records):
        terms = [r[k] for k in OPTIMIZED_LOSS_NAMES + ("grad_norm", "lr")]
        extra = r["total_loss"] - r["token_kd_loss"]
        beta = od.beta * min(1.0, r["epoch"] / od.warmup_epochs)
        want = {s: (onecycle_f64(r["sched_t"], tr.learning_rate * s, total),
                    wd) for s, wd in ((tr.encoder_lr_scale, tr.weight_decay),
                                      (1.0, tr.weight_decay),
                                      (tr.others_lr_scale,
                                       tr.others_weight_decay))}
        rates_ok = set(r["groups"]) == set(want) and all(
            abs(r["groups"][s][0] - want[s][0]) <= 1e-12 * want[s][0]
            and r["groups"][s][1] == want[s][1] for s in want)
        ok = (np.isfinite(terms).all() and r["sched_t"] == first_step + i
              and r["epoch"] == epochs[i] and rates_ok
              and r["compact_scan"] == KD_A
              and (extra == 0.0 if r["epoch"] == 0 else
                   extra != 0.0 and abs(extra - beta * r["feature_kd_loss"])
                   <= 1e-5 * abs(r["total_loss"])))
        if not ok:
            bad.append((i, dict(finite=bool(np.isfinite(terms).all()),
                                step=r["sched_t"], epoch=r["epoch"],
                                rates=rates_ok, launches=r["compact_scan"],
                                extra=extra)))
    if len(records) != n_steps or bad:
        fail(f"optimized KD steps: {len(records)} of {n_steps}; steps out "
             f"of contract: {bad}; rates {[r['groups'] for r in records]}")


def optimized_card_vs_cpu(dev, root, csv_path, t_ckpt):
    """One float32 optimized step on the card (kernels) against the same
    step on the CPU (plain versions): dropout off, A=1 x B=4 images read at
    256, their crop offsets, angles, jitter factors and flips handed in,
    epoch 1, global step 2 of 30; full width."""
    cfg = dataclasses.replace(compact_student_config(VOCAB), dropout=0.0)
    tr, od = OptimizedKDTrainConfig(), OptimizedDistillConfig()
    loader, _ = TK.get_loader(root, csv_path, batch_size=OPT_CPU_B,
                              max_caption_len=KD_T + 1, shuffle=False,
                              image_size=OPT_HOST)
    batch = next(iter(common.stacked_batches(loader, 1)))
    rng = np.random.default_rng(SEED + 41)
    n = OPT_CPU_B
    draws = dict(offsets=[rng.integers(0, OPT_HOST - DISK_SIZE + 1, n)
                          for _ in range(2)],
                 theta=rng.uniform(-5.0, 5.0, n).astype(np.float32),
                 factors={k: rng.uniform(0.8, 1.2, (n, 1, 1, 1)).astype(
                     np.float32) for k in ("brightness", "contrast",
                                           "saturation")},
                 hue=rng.uniform(-0.1, 0.1, (n, 1, 1)).astype(np.float32),
                 flip=rng.random(n) < 0.5)
    aug = dataclasses.replace(T.OPTIMIZED_KD_AUG, out_size=DISK_SIZE)
    results = {}
    real_aug = T.augment_and_normalize
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        def put(a):
            return torch.from_numpy(np.asarray(a)).to(where)
        handed = dict(offsets=tuple(put(o) for o in draws["offsets"]),
                      theta=put(draws["theta"]), flip=put(draws["flip"]),
                      factors=dict({k: put(v) for k, v in
                                    draws["factors"].items()},
                                   hue=put(draws["hue"])))
        teacher, t_cfg = TK.load_teacher(t_ckpt, VOCAB, where)
        student, projectors = TK.make_student_and_projectors(cfg, t_cfg, SEED,
                                                             where)
        state = steps.init_train_state(student, projectors, cfg)
        step = steps.make_kd_train_step(
            teacher, t_cfg, cfg, None, tr, aug=aug,
            compute_dtype=torch.float32, optimized=True, od_cfg=od,
            onecycle_total_steps=30, others_scale=tr.others_lr_scale,
            others_wd=tr.others_weight_decay)
        before = (S.launches_compact, A.launches)
        T.augment_and_normalize = functools.partial(real_aug, draws=handed)
        try:
            with M.no_dropout():
                metrics = step(state, steps.batch_to_device(batch, where), 2,
                               None, 1)
        finally:
            T.augment_and_normalize = real_aug
        results[tag] = {k: float(v) for k, v in metrics.items()}
        launched = (S.launches_compact - before[0], A.launches - before[1])
        if (min(launched) < 1) if tag == "card" else any(launched):
            fail(f"the float32 optimized step on {where} launched (#7, #2) "
                 f"{launched} times")
    for k in OPTIMIZED_LOSS_NAMES + ("grad_norm",):
        g, c = results["card"][k], results["cpu"][k]
        limit = (OPT_CARD_CPU_GNORM_LIMIT if k == "grad_norm"
                 else OPT_CARD_CPU_LOSS_LIMIT)
        rel = abs(g - c) / max(abs(c), 1e-12) if c else abs(g)
        ok = np.isfinite(g) and rel <= limit
        print(f"fp32 optimized KD step card vs CPU {k}: {g:.7g} vs {c:.7g}, "
              f"relative {rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("the card's float32 optimized KD step disagrees with the "
                 "CPU's")
    return results


def run_optimized_kd(dev, tmp, root, csv_path, t_ckpt):
    """The optimized trainer at full width on the disk dataset: 2 epochs of
    3 steps of A=2 x B=16 (training images at 256 cropped to 224, bf16,
    the compact student), fast validation at 224, the best checkpoint, the
    history; a resume from the best into the next epoch; the float32 step
    card against CPU; the step's times.  Returns launches and times."""
    tr, od = OptimizedKDTrainConfig(), OptimizedDistillConfig()
    kw = dict(max_caption_len=KD_T + 1, image_size=DISK_SIZE,
              compute_dtype=torch.bfloat16, seed=SEED,
              max_steps_per_epoch=OPT_STEPS, data_parallel=False,
              verbose=False, device=dev)
    per_epoch = (len(CaptionDataset(root, csv_path)) // tr.batch_size
                 // tr.accumulation_steps)
    out = os.path.join(tmp, "optimized_out")
    records = []
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with recording_kd_steps(records):
        state, s_cfg, vocab = OPT.train_student_with_kd_optimized(
            root, csv_path, t_ckpt, out, num_epochs=OPT_EPOCHS, **kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = kd_counters("compact")
    check_optimized_records(records, tr, od, OPT_EPOCHS * OPT_STEPS, 0,
                            [e for e in range(OPT_EPOCHS)
                             for _ in range(OPT_STEPS)],
                            per_epoch * OPT_EPOCHS)
    best = os.path.join(out, OPT.BEST)
    hist = json.load(open(os.path.join(out, OPT.HISTORY)))
    per_step = {"compact_scan": [r["compact_scan"] for r in records],
                "attention_core": [r["attention_core"] for r in records]}
    print(f"optimized train: V={len(vocab)}, {len(records)} steps at global "
          f"steps {[r['sched_t'] for r in records]}, epochs "
          f"{[r['epoch'] for r in records]}; total, token, feature terms "
          f"{[(round(r['total_loss'], 4), round(r['token_kd_loss'], 4), round(r['feature_kd_loss'], 4)) for r in records]}; "
          f"rates and decays by scale {records[-1]['groups']}; launches a "
          f"step {per_step}; all {train}; history val {hist['val_losses']} "
          f"({train_s:.2f} s)", flush=True)
    if s_cfg.variant != "compact" or len(vocab) != VOCAB \
            or not os.path.exists(best) or min(train.values()) < 1 \
            or len(hist["train_losses"]) != OPT_EPOCHS \
            or not np.isfinite(hist["train_losses"] + hist["val_losses"]).all():
        fail("the optimized training run did not train the compact student, "
             "launch its kernels, or land its checkpoint and history")

    ck = load_checkpoint(best)
    saved_mu = CV.tree_to_state_dict(ck["optimizer_state_dict"]["mu"])
    saved_step = int(ck["scheduler_state_dict"]["global_step"])
    epoch = int(ck["epoch"]) + 1
    records.clear()
    zero_counters()
    t0 = time.perf_counter()
    with recording_kd_steps(records):
        state, _, _ = OPT.train_student_with_kd_optimized(
            root, csv_path, t_ckpt, os.path.join(tmp, "optimized_resumed"),
            num_epochs=epoch + 1, resume_from=best, **kw)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume = kd_counters("compact")
    check_optimized_records(records, tr, od, OPT_STEPS, saved_step,
                            [epoch] * OPT_STEPS, per_epoch * (epoch + 1))
    first = records[0]
    same_mu = set(first.get("mu_before", {})) == set(saved_mu) and all(
        torch.equal(first["mu_before"][n], saved_mu[n]) for n in saved_mu)
    print(f"optimized resume: from global step {saved_step} at epoch "
          f"{int(ck['epoch'])}: first step at global step {first['sched_t']}"
          f", epoch {first['epoch']}, from optimizer step "
          f"{first['step_before']}, its first moments the checkpoint's bit "
          f"for bit: {same_mu}; to step {state.opt_state.step}; launches "
          f"{resume} ({resume_s:.2f} s)", flush=True)
    if first["step_before"] != int(ck["optimizer_state_dict"]["step"]) \
            or not same_mu or min(resume.values()) < 1:
        fail("the resumed optimized run did not go on from the checkpoint")
    both = optimized_card_vs_cpu(dev, root, csv_path, t_ckpt)
    times = time_optimized_steps(dev, state, s_cfg, root, csv_path, t_ckpt)
    times.update(train_s=train_s, resume_s=resume_s,
                 compact_scan_per_step=KD_A,
                 attention_core_per_step=per_step["attention_core"][0])
    return {"train": train, "resume": resume}, times, both, best


def time_optimized_steps(dev, state, s_cfg, root, csv_path, t_ckpt, n=4):
    """Further bf16 optimized steps on the trained state: host clock around
    each step (ending in a synchronise) and CUDA events around it."""
    tr, od = OptimizedKDTrainConfig(), OptimizedDistillConfig()
    teacher, t_cfg = TK.load_teacher(t_ckpt, VOCAB, dev)
    step = steps.make_kd_train_step(
        teacher, t_cfg, s_cfg, None, tr,
        aug=dataclasses.replace(T.OPTIMIZED_KD_AUG, out_size=DISK_SIZE),
        compute_dtype=torch.bfloat16, optimized=True, od_cfg=od,
        onecycle_total_steps=30, others_scale=tr.others_lr_scale,
        others_wd=tr.others_weight_decay)
    loader, _ = TK.get_loader(root, csv_path, batch_size=KD_B,
                              max_caption_len=KD_T + 1, shuffle=False,
                              image_size=OPT_HOST)
    stacks = list(itertools.islice(common.stacked_batches(loader, KD_A), 3))
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    wall, span_ms = [], []
    for i in range(n + 1):
        batch = steps.batch_to_device(stacks[i % len(stacks)], dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch, 5 + i, gen, 1)
        end.record()
        float(metrics["total_loss"])
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
    out = dict(wall_ms=statistics.median(wall[1:]),
               span_ms=statistics.median(span_ms[1:]),
               wall_ms_all=wall[1:], span_ms_all=span_ms[1:],
               images_per_s=KD_A * KD_B / (statistics.median(wall[1:]) / 1e3))
    print(f"optimized KD step bf16 A={KD_A} x B={KD_B} T={KD_T} (compact, "
          f"float32 teacher): wall {out['wall_ms']:.3f} ms (host clock, "
          f"synchronised), span {out['span_ms']:.3f} ms (CUDA events around "
          f"the step, idle gaps included), median of {n}; "
          f"{out['images_per_s']:.1f} images/s", flush=True)
    return out


def run_kd_pipeline_twin(dev, tmp, root, csv_path, t_ckpt):
    """The pipeline twin as a subprocess on the disk dataset: the KD trainer
    (full student, 1 epoch) then the evaluator, on the card; it must exit 0
    and every artifact it lists must exist.  Its kernels launch in the
    child processes, whose counters this process cannot read: the same
    trainer and evaluator are counted in the disk pipeline's phase."""
    out = os.path.join(tmp, "pipeline_out")
    cmd = [sys.executable, "-m", "imagecaptioner_tpu_torch.runners."
           "run_kd_pipeline", "--data-root", root, "--captions-file",
           csv_path, "--teacher-checkpoint", t_ckpt, "--output-dir", out,
           "--epochs", "1", "--max-samples", str(KD_B), "--device", dev.type]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    listed = [line.split(None, 1) for line in proc.stdout.splitlines()
              if line.startswith("  [ok] ") or line.startswith("  [missing] ")]
    listed = [p.strip() for tag, p in listed if tag in ("[ok]", "[missing]")
              and "package" not in p and ":" not in p]
    paths = [p if os.path.isabs(p) else os.path.join(tmp, p) for p in listed]
    missing = [p for p in paths if not os.path.exists(p)]
    print(f"pipeline twin: exit {proc.returncode} in {wall_s:.2f} s; "
          f"artifacts {[os.path.basename(p) for p in paths]}, missing "
          f"{missing}", flush=True)
    if proc.returncode != 0 or len(paths) != 5 or missing:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the pipeline twin did not exit 0 with all its artifacts")
    return out, wall_s


def run_demo_twin(dev, tmp, root, t_ckpt, vocab_path, full_ckpt, compact_ckpt):
    """The demo twin: ``demo_caption_image`` on a PPM at 256 (read and
    resized by numpy) with the port teacher (beam at T = 1.0 through #9 and
    #10) and the teacher as its student; again with the pipeline's full
    student; the full and the optimized compact student at T = 1.0 (their
    greedy kernels).  Returns the launch counts."""
    image = os.path.join(tmp, "demo.ppm")
    write_ppm(image, np.random.default_rng(SEED + 51).integers(
        0, 256, (OPT_HOST, OPT_HOST, 3), dtype=np.uint8))
    zero_counters()
    teacher_only = DEMO.demo_caption_image(image, checkpoint_path=t_ckpt,
                                           vocab_path=vocab_path, device=dev)
    beam = {"attention_core": A.launches, "beam_self_attention":
            BA.launches_self, "beam_cross_attention": BA.launches_cross}
    with_full = DEMO.demo_caption_image(image, checkpoint_path=t_ckpt,
                                        vocab_path=vocab_path, device=dev,
                                        student_checkpoint=full_ckpt)
    vocab = Vocabulary.load(vocab_path)
    x = DEMO.preprocess_image(DS.decode_image_file(image, DISK_SIZE),
                              DISK_SIZE, device=dev)
    greedy = {}
    for name, ckpt, counter in (("full", full_ckpt, "greedy_decode"),
                                ("compact", compact_ckpt,
                                 "greedy_decode_compact")):
        G.launches = G.launches_compact = 0
        greedy[name] = DEMO.generate_caption_with_temperature(
            serve.load_student(ckpt, dev), x, vocab, temperature=1.0)
        beam[counter] = (G.launches if name == "full"
                         else G.launches_compact)
    print(f"demo twin: teacher {teacher_only['teacher'][:60]!r}, teacher as "
          f"student (T=1.1) {teacher_only['student'][:40]!r}; full student "
          f"(T=1.1) {with_full['student'][:40]!r}; greedy at T=1.0 "
          f"{ {k: v[:40] for k, v in greedy.items()} }; launches {beam}",
          flush=True)
    if min(beam.values()) < 1 or with_full["teacher"] != \
            teacher_only["teacher"] or not all(isinstance(v, str) for v in (
                *teacher_only.values(), *with_full.values(),
                *greedy.values())):
        fail("the demo twin did not caption through its kernels")
    return beam


# ---------------------------------------------------------------------------
# Reference checkpoints: .pth in the reference's naming -> the port
# ---------------------------------------------------------------------------


def write_reference_pth(path: str, sd: dict) -> None:
    """A state dict in the reference's key naming, in the reference's
    checkpoint dict, by ``torch.save``."""
    torch.save({"epoch": 0, "vocab_size": VOCAB, "model_state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
        path)


def same_parameters(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def run_reference_pth(dev, tmp, batches):
    """The sharpened teacher of the beam phase and the full student of the
    serving phase, exported to the reference's naming and read back through
    ``load_reference_pth`` -> ``*_from_reference`` -> ``strict=True``; each
    serves one batch, whose outputs must equal the ``.npz`` path's bit for
    bit.  Returns the launch counts."""
    npz = os.path.join(tmp, "ref_teacher.npz")
    write_beam_teacher(npz)
    cfg = TeacherConfig(vocab_size=VOCAB)
    pth = os.path.join(tmp, "best_teacher_model.pth")
    write_reference_pth(pth, RP.teacher_to_reference(
        load_checkpoint(npz)["model_state_dict"]["params"], cfg))
    ck = RP.load_reference_pth(pth)
    t_keys = len(ck["model_state_dict"])
    r_cfg = TeacherConfig(vocab_size=int(ck["vocab_size"]))
    r_teacher = TM.Teacher(r_cfg)
    r_teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        RP.teacher_from_reference(ck["model_state_dict"], r_cfg)), strict=True)
    r_teacher = r_teacher.to(dev).eval()
    n_teacher, n_cfg = serve.load_teacher(npz, dev)
    images = beam_images(1, SEED + 41)[0]
    kw = dict(max_length=MAX_LEN, beam_size=BEAM_K)
    zero_counters()
    got = serve.make_beam_captioner(r_teacher, r_cfg, dev, **kw)(images)
    teacher = {"attention_core": A.launches,
               "beam_self_attention": BA.launches_self,
               "beam_cross_attention": BA.launches_cross}
    want = serve.make_beam_captioner(n_teacher, n_cfg, dev, **kw)(images)
    t_same = all(np.array_equal(a, b) for a, b in zip(got, want))
    t_params = same_parameters(r_teacher, n_teacher)
    del r_teacher, n_teacher

    npz = write_student(tmp, "full")
    params, s_cfg, mstate = load_student_checkpoint(npz)
    pth = os.path.join(tmp, "best_student_model.pth")
    write_reference_pth(pth, RP.full_student_to_reference(params, mstate,
                                                          s_cfg))
    ck = RP.load_reference_pth(pth)
    r_cfg = full_student_config(int(ck["vocab_size"]))
    r_params, r_state = RP.full_student_from_reference(ck["model_state_dict"],
                                                       r_cfg)
    r_student = Student(r_cfg)
    r_student.load_state_dict(CV.jax_student_to_state_dict(r_params, r_state,
                                                           r_cfg), strict=True)
    r_student = M.cast_parameters(r_student, torch.bfloat16).to(dev).eval()
    n_student, n_cfg = serve.load_student(npz, dev, torch.bfloat16)
    zero_counters()
    got = serve.make_greedy_captioner(r_student, r_cfg, dev,
                                      max_length=MAX_LEN)(batches[0])
    student = {"attention_core": A.launches, "greedy_decode": G.launches}
    want = serve.make_greedy_captioner(n_student, n_cfg, dev,
                                       max_length=MAX_LEN)(batches[0])
    s_same = np.array_equal(got, want)
    s_params = same_parameters(r_student, n_student)
    print(f"reference .pth: teacher ({t_keys} keys) parameters identical "
          f"to the .npz path's {t_params}, beam outputs of {BEAM_B} images "
          f"bit for bit {t_same}, launches {teacher}; full student "
          f"({len(ck['model_state_dict'])} keys) parameters identical "
          f"{s_params}, greedy tokens of {len(got)} images bit for bit "
          f"{s_same}, launches {student}", flush=True)
    if not (t_same and t_params and s_same and s_params) \
            or min(teacher.values()) < 1 or min(student.values()) < 1:
        fail("a model imported from a reference .pth serves differently from "
             "its .npz twin")
    return {"teacher": teacher, "student": student}


def forget_libraries() -> None:
    """Drop every loaded kernel library and the grids asked of them, so that
    the next launch loads the library built from the current
    ``_build.CSRC``."""
    _build._LIBS.clear()
    _build._GRIDS.clear()
    _build._WORKSPACES.clear()
    A._KERNEL = G._GREEDY = G._COMPACT = S._FWD = S._BWD = S._COMPACT = None
    BA._KERNELS = ES._LIB = None


def mutant_caught(source: str, good: str, bad: str, check, what: str) -> bool:
    """Build a copy of ``csrc/`` in which one line of ``source`` is replaced
    and run ``check`` on it: the check must fail.  The copy lives in a
    temporary directory; the repository's sources are not touched."""
    tmp = tempfile.mkdtemp(prefix="ic_mutant_")
    real = _build.CSRC
    forget_libraries()
    try:
        for f in real.glob("*.cu*"):
            shutil.copy(f, tmp)
        path = os.path.join(tmp, source)
        src = open(path).read()
        if src.count(good) != 1:
            fail(f"the line to mutate was not found in {source}")
        open(path, "w").write(src.replace(good, bad))
        _build.CSRC = type(real)(tmp)
        try:
            check()
        except SystemExit:
            print(f"mutation run: the check caught the mutant ({what}): ok",
                  flush=True)
            return True
        print(f"mutation run: the mutant ({what}) PASSED its check: the check "
              "has no power", file=sys.stderr, flush=True)
        return False
    finally:
        _build.CSRC = real
        forget_libraries()
        shutil.rmtree(tmp, ignore_errors=True)


def run_mutation(dev) -> int:
    """Eleven planted faults, each of which its check must catch: the scan
    backward without the dropout mask on layer 1's input gradient (``dh0 =
    dh0_c + (dgp1·W_ih1ᵀ) · mask``), a beam self-attention that reads its
    own slot's cache row instead of ``anc[n, i, s]``, one that stages each
    chunk of cache rows from position 0 instead of the chunk's first
    position (only the chunked case, K=10 at S=64 in float32, can see it),
    an enhanced scan
    whose attention heads ignore their dropout multiplier ``amask``, an
    attention core whose causal mask lets each row see one key ahead, two
    faults in the cross-block exchange of the cooperative chains (a greedy
    decode whose blocks all read batch row 0's context from L2 when they
    build x0, a scan forward whose layer 1 reads the broadcast h0 without
    its dropout mask), an enhanced scan whose blocks publish their
    LayerNorm partials at step 0 only, so that every later LayerNorm
    combines stale partials, a beam cross-attention whose bulk copy of V
    drops the last 16 keys, a compact greedy decode whose row blocks all
    reduce row 0's partial argmaxes, and a compact scan whose cell reads
    the previous step's recurrent part at even steps."""
    decoder = make_decoder(dev)
    g_decoder, g_feats = greedy_inputs(dev)
    c_decoder, c_feats = compact_greedy_inputs(dev)
    caught = [
        mutant_caught("greedy_decode.cu",
                      "ctxsrc{a.ctx, E, E, nullptr}",
                      "ctxsrc{a.ctx, 0, E, nullptr}",
                      lambda: check_greedy(g_decoder, g_feats, mutant=True),
                      "every row reads row 0's broadcast context"),
        mutant_caught("decoder_scan.cu",
                      "const float fed = a.mask ? h * a.mask[n * H + j] : h;",
                      "const float fed = h;",
                      lambda: check_scan(decoder, dev, mutant="fwd"),
                      "layer 1 reads the broadcast h0 without its mask"),
        mutant_caught("attention_core.cu",
                      "if (col >= Lk || (causal && col > row)) x = -INFINITY;",
                      "if (col >= Lk || (causal && col > row + 1)) x = -INFINITY;",
                      lambda: check_attention(
                          dev, torch.Generator(device=dev).manual_seed(SEED)),
                      "causal mask lets each row see one key ahead"),
        mutant_caught("decoder_scan_bwd.cu",
                      "const float dh0 = a.dh0c[rj] + s.px[r * CMAX + c] * m;",
                      "const float dh0 = a.dh0c[rj] + s.px[r * CMAX + c];",
                      lambda: check_scan(decoder, dev, mutant="bwd"),
                      "no dropout mask on d(h0)"),
        mutant_caught("beam_attention.cu",
                      "a[u] = live && s < len ? anc[(size_t)r * S + s] : 0;",
                      "a[u] = live && s < len ? g0 + warp : 0;",
                      lambda: check_beam_attention(dev, mutant=True),
                      "beam self-attention ignores anc"),
        mutant_caught("beam_attention.cu",
                      "* H + h) * S + ch.s0) * D, bytes",
                      "* H + h) * S) * D, bytes",
                      lambda: check_beam_attention(dev, mutant=True),
                      "beam self-attention stages every chunk from position "
                      "0"),
        mutant_caught("beam_attention.cu",
                      "bulk_load(v_s, mv + nh * L * D, bytes, &bar[1]);",
                      "bulk_load(v_s, mv + nh * L * D, bytes - 16 * D * "
                      "sizeof(T), &bar[1]);",
                      lambda: check_beam_attention(dev, mutant=True),
                      "beam cross-attention's V copy drops its last 16 keys"),
        mutant_caught("enhanced_scan.cu",
                      "sc[l] = sc[l] / sum * (am ? am[l] : 1.f);",
                      "sc[l] = sc[l] / sum;",
                      lambda: check_enhanced_scan(
                          make_variant_decoder("enhanced", dev), dev,
                          mutant=True),
                      "enhanced scan ignores amask"),
        mutant_caught("enhanced_scan.cu",
                      "*mine = make_float2(mean, m2);",
                      "if (t == 0) *mine = make_float2(mean, m2);",
                      lambda: check_enhanced_scan(
                          make_variant_decoder("enhanced", dev), dev,
                          mutant=True),
                      "enhanced scan reads stale LayerNorm partials"),
        mutant_caught("greedy_decode_compact.cu",
                      "a.best + (size_t)blk * nblk;",
                      "a.best + (size_t)0 * nblk;",
                      lambda: check_greedy_compact(c_decoder, c_feats,
                                                   mutant=True),
                      "every row block reduces row 0's partial argmaxes"),
        mutant_caught("compact_scan.cu",
                      "product(A, M, hh, ldH, GATE_ROWS, rec, GATE_ROWS, part);",
                      "if (t % 2) product(A, M, hh, ldH, GATE_ROWS, rec, "
                      "GATE_ROWS, part);",
                      lambda: check_compact_scan(
                          make_variant_decoder("compact", dev), dev,
                          mutant=True),
                      "the cell reads the previous step's recurrent part at "
                      "even steps"),
    ]
    return 0 if all(caught) else 1


def make_decoder(dev):
    """A full-width decoder at its default init from the numpy seed."""
    cfg = decoder_cfg()
    decoder = L.FullDecoder(cfg)
    decoder.load_state_dict(CV.tree_to_state_dict(
        L.FullDecoder.init(np.random.default_rng(SEED + 4), cfg)), strict=True)
    return decoder.to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on the card")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--mutation" in sys.argv[1:]:
        return run_mutation(dev)

    secs = _build.build_all(_build.SOURCES + (PROBE,))
    print(f"built {', '.join(_build.SOURCES + (PROBE,))} in {secs:.1f} s",
          flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # --- 4. dense at bf16 on tensor cores; attention kernel vs plain --------
    check_dense(dev)
    attn_err = check_attention(dev, gen)
    check_attention_kd(dev, gen)
    attn_t = time_attention(dev, gen)

    # --- full student from a numpy seed, written as a JAX checkpoint ---
    cfg = full_student_config(VOCAB)
    params, state = student_init(SEED, cfg)
    sharpen_decoder(params["decoder"])
    rng = np.random.default_rng(SEED + 1)
    batches = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
               for _ in range(N_BATCHES)]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "student.npz")
        save_checkpoint(ckpt, {
            "student_state_dict": {"params": params, "model_state": state},
            "vocab_size": VOCAB,
            "model_config": dict(embed_size=cfg.embed_size,
                                 hidden_size=cfg.hidden_size,
                                 num_layers=cfg.num_layers,
                                 dropout=cfg.dropout,
                                 use_attention_refinement=True,
                                 model_type="full")})
        vocab = Vocabulary(freq_threshold=5)
        vocab.itos = {i: SPECIALS.get(i, f"tok{i}") for i in range(VOCAB)}
        vocab.stoi = {w: i for i, w in vocab.itos.items()}
        vocab.save(os.path.join(tmp, "vocab.json"))
        vocab = Vocabulary.load(os.path.join(tmp, "vocab.json"))
        model32, _ = serve.load_student(ckpt, dev, torch.float32)
        model16, cfg16 = serve.load_student(ckpt, dev, torch.bfloat16)
        model_cpu, _ = serve.load_student(ckpt, "cpu", torch.float32)

    # --- 5. greedy kernel vs plain, at the main path's shapes -----------
    # Features drawn per row: a random ResNet gives near-identical features
    # for all noise images, which would leave the rows' tokens alike.
    feats32 = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, cfg.feature_tokens, cfg.embed_size)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        greedy_diff, bf16_rows, greedy_ms, greedy_plain_ms = check_greedy(
            model32.decoder, feats32)

    # --- 6. decoder-scan kernels vs plain, at the KD step's shapes --------
    scan = check_scan(make_decoder(dev), dev)
    check_chain_batches(model32.decoder, make_decoder(dev), dev)
    scan_t = time_scan(scan)
    scan_b = scan_bounds(scan)

    # --- 7. the serving path: serve loader -> captioner, bf16 -----------
    caption = serve.make_greedy_captioner(model16, cfg16, dev,
                                          max_length=MAX_LEN)
    caption(batches[0])                                   # warm-up
    torch.cuda.synchronize()
    A.launches = G.launches = 0
    tokens, batch_s = [], []
    for b in batches:      # each call ends in a device-to-host copy
        t0 = time.perf_counter()
        tokens.append(caption(b))
        batch_s.append(time.perf_counter() - t0)
    launches = {"attention_core": A.launches, "greedy_decode": G.launches}
    print(f"serving path launches: {launches}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the serving path was not launched: {launches}")
    toks = np.concatenate(tokens)
    if toks.shape != (BATCH * N_BATCHES, MAX_LEN) or toks.dtype != np.int32 \
            or toks.min() < 0 or toks.max() >= VOCAB:
        fail(f"tokens out of contract: {toks.shape} {toks.dtype}")
    captions = [D.tokens_to_caption(t, vocab) for t in toks]
    print(f"captioned {len(captions)} images, {len(set(captions))} distinct "
          f"captions; longest: {max(captions, key=len)!r}")
    imgs_per_s = BATCH * N_BATCHES / sum(batch_s)
    print(f"end-to-end: {imgs_per_s:.1f} images/s (bf16, B={BATCH} x "
          f"{N_BATCHES} batches, T={MAX_LEN}, host clock incl. H2D/D2H); "
          f"per batch ms: median {1e3 * statistics.median(batch_s):.3f}, "
          f"min {1e3 * min(batch_s):.3f}, max {1e3 * max(batch_s):.3f}",
          flush=True)

    # float32 on the card (both kernels) vs the all-plain CPU path
    small = batches[1][:4]
    with torch.inference_mode():
        xg = T.normalize(torch.from_numpy(small).to(dev))
        xc = T.normalize(torch.from_numpy(small))
        fg = model32.encode_image(xg)[1].cpu()
        fc = model_cpu.encode_image(xc)[1]
    feat_err = (fg - fc).abs().max().item()
    tg = serve.make_greedy_captioner(model32, cfg16, dev)(small)
    tc = serve.make_greedy_captioner(model_cpu, cfg16, "cpu")(small)
    rows = int((tg == tc).all(axis=1).sum())
    ok = np.isfinite(fg.numpy()).all() and feat_err <= 1e-3 and rows >= 3
    print(f"fp32 card vs CPU on 4 images: refined max_abs_err {feat_err:.3e} "
          f"(limit 1e-3), {rows}/4 caption rows identical (need 3) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's float32 path disagrees with the CPU reference")

    # --- 8. the training path: the KD trainer at full width ---------------
    with tempfile.TemporaryDirectory() as tmp:
        kd_launches, kd_state, s_cfg, t_ckpt, kd_loader = run_kd(dev, tmp)
        step_s = time_kd_steps(dev, kd_state, s_cfg, t_ckpt, kd_loader)
        both = card_vs_cpu_step(dev, s_cfg, t_ckpt, kd_loader)
    kd_imgs_per_s = KD_A * KD_B / statistics.median(step_s)
    print(f"KD step: {kd_imgs_per_s:.1f} images/s (bf16 compute, float32 "
          f"teacher, A={KD_A} x B={KD_B}, T={KD_T}, host clock incl. H2D); "
          f"per step ms: median {1e3 * statistics.median(step_s):.3f}, min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}", flush=True)
    compare_card_cpu(both, "full")

    # --- 9. beam-step attention kernels vs plain, at the teacher's width ----
    beam_err = check_beam_attention(dev)
    beam_t = time_beam_attention(dev)

    # --- 10. teacher beam serving: serve loader -> beam captioner ----------
    with tempfile.TemporaryDirectory() as tmp:
        beam_launches, beam_rates, beam_split = run_beam(dev, tmp)

    # --- 11. the disk pipeline: CSV/PPM data, trainer, resume, evaluators;
    # then the teacher trainer on the same dataset -------------------------
    with tempfile.TemporaryDirectory() as tmp:
        disk_launches, disk_times = run_disk_pipeline(dev, tmp, smi)
        root = os.path.join(tmp, "flickr")
        csv_path = os.path.join(root, "captions_clean.csv")
        teach_launches, teach_times, teach_both = run_teacher_training(
            dev, tmp, root, csv_path)

        # --- 11c-e. the optimized trainer; the pipeline and demo twins ----
        t_ckpt = os.path.join(tmp, "teacher.npz")
        opt_launches, opt_times, opt_both, opt_best = run_optimized_kd(
            dev, tmp, root, csv_path, t_ckpt)
        pipe_out, pipe_s = run_kd_pipeline_twin(dev, tmp, root, csv_path,
                                                t_ckpt)
        demo_launches = run_demo_twin(
            dev, tmp, root, t_ckpt, os.path.join(pipe_out, "vocab.json"),
            os.path.join(pipe_out, "best_student_model.npz"), opt_best)

    # --- 11f. reference checkpoints (.pth) -> the port, served ----------------
    with tempfile.TemporaryDirectory() as tmp:
        ref_launches = run_reference_pth(dev, tmp, batches)

    def summed(runs):
        return {k: sum(d.get(k, 0) for d in runs.values())
                for k in ("attention_core", "greedy_decode", "decoder_scan",
                          "decoder_scan_train", "decoder_scan_bwd",
                          "beam_self_attention", "beam_cross_attention",
                          "greedy_decode_compact", "compact_scan")}

    later = {"disk_pipeline": summed(disk_launches),
             "teacher_training": summed(teach_launches),
             "optimized_kd": summed(opt_launches),
             "demo": summed({"demo": demo_launches}),
             "reference_pth": summed(ref_launches)}

    # --- 12. the compact student: kernels #3 and #7, serving, KD ------------
    attn48_err = check_attention_48(dev, gen)
    c_decoder = make_variant_decoder("compact", dev)
    cscan = check_compact_scan(c_decoder, dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_student(tmp, "compact")
        c_launches, c_rate, _, c_model32 = serve_variant(
            dev, ckpt, batches, "compact",
            lambda: {"greedy_decode_compact": G.launches_compact})
        c_feats32 = seeded(np.random.default_rng(SEED + 2),
                           (BATCH, 49, c_model32.cfg.embed_size), dev)
        with torch.inference_mode():
            cg_diff, cg_rows, cg_ms, cg_plain_ms, cg_ops = check_greedy_compact(
                c_model32.decoder, c_feats32)
        check_compact_batches(c_model32.decoder, c_decoder, dev)
        ckd_launches, ckd_rate, _ = run_variant_kd(dev, tmp, "compact")

    # --- 13. the enhanced student: kernel #8, serving, KD ---------------------
    e_decoder = make_variant_decoder("enhanced", dev)
    escan = time_enhanced_scan(check_enhanced_scan(e_decoder, dev))
    check_enhanced_batches(e_decoder, dev)
    del e_decoder
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_student(tmp, "enhanced")
        e_launches, e_rate, _, e_model32 = serve_variant(
            dev, ckpt, batches, "enhanced",
            lambda: {"attention_core": A.launches})
        check_enhanced_loop(e_model32, dev)
        ekd_launches, ekd_rate, _ = run_variant_kd(dev, tmp, "enhanced")
    del c_model32, e_model32

    # --- 14./15. timings, bounds and the result lines ----------------------
    floors = chain_floors(dev)
    usage = {src: ptxas_usage(src, kernel) for src, kernel in (
        ("greedy_decode", "greedy_kernel"), ("decoder_scan", "scan_kernel"),
        ("decoder_scan_bwd", "chain_kernel"),
        ("enhanced_scan", "enhanced_scan_kernel"),
        ("greedy_decode_compact", "greedy_compact_kernel"),
        ("compact_scan", "compact_scan_kernel"))}
    print(f"greedy_decode B=32 T=20 bf16: kernel {greedy_ms:.4f} ms, "
          f"plain {greedy_plain_ms:.4f} ms")
    print_scan_times(scan_t, scan_b)
    w16 = G.greedy_operands(model16.decoder, torch.bfloat16)
    greedy_macs = sum(w16[k].numel() for k in (
        "w_attn", "w_comb", "w_ih0", "w_hh0", "w_ih1", "w_hh1", "fc1_w",
        "fc2_w")) - cfg.embed_size * cfg.embed_size   # W_f runs outside
    greedy_bound = bound_ms(
        nbytes(*(w16[k] for k in w16 if k != "b_attn"))
        + 2 * BATCH * cfg.feature_tokens * cfg.embed_size * 2
        + BATCH * MAX_LEN * 4,
        2 * greedy_macs * BATCH * MAX_LEN, "bf16")

    def entry(name, source, replaces, n, err, ms, plain, bound, library=None,
              **more):
        return dict(name=name, route="cuda",
                    source=f"imagecaptioner_tpu_torch/csrc/{source}",
                    replaces=f"imagecaptioner_tpu/ops/{replaces}", launches=n,
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=library, **more)

    for tag, t in beam_t.items():
        print(f"beam attention N={BEAM_B} K={BEAM_K} pos={MAX_LEN - 1} {tag}: "
              f"self kernel {t['self_ms']:.4f} ms (plain "
              f"{t['self_plain_ms']:.4f}, all-slots SDPA "
              f"{t['self_sdpa_ms']:.4f} off the plain version by "
              f"{t['self_sdpa_err']:.3e}, bound {t['bounds']['self'][0]:.5f} "
              f"by {t['bounds']['self'][1]}); cross kernel "
              f"{t['cross_ms']:.4f} ms "
              f"(plain {t['cross_plain_ms']:.4f}, SDPA {t['cross_sdpa_ms']:.4f}"
              f", bound {t['bounds']['cross'][0]:.5f} by "
              f"{t['bounds']['cross'][1]}); with the stream kept full: self "
              f"{t['self_queued_ms']:.4f} ms (SDPA "
              f"{t['self_sdpa_queued_ms']:.4f}), cross "
              f"{t['cross_queued_ms']:.4f} ms (SDPA "
              f"{t['cross_sdpa_queued_ms']:.4f})")
    print(f"greedy_decode_compact B=32 T=20 bf16: kernel {cg_ms:.4f} ms, "
          f"plain {cg_plain_ms:.4f} ms")
    print(f"compact_scan T={KD_T} B={KD_B} bf16: kernel {cscan['ms']:.4f} ms, "
          f"plain {cscan['plain_ms']:.4f} ms; its plain backward "
          f"{cscan['bwd_plain_ms']:.4f} ms")
    print(f"enhanced_scan T={KD_T} B={KD_B} bf16 with masks: kernel "
          f"{escan['ms']:.4f} ms (float32 {escan['f32_ms']:.4f}), plain "
          f"{escan['plain_ms']:.4f} ms; its plain backward "
          f"{escan['bwd_plain_ms']:.4f} ms")
    lstm, bt = "pallas_lstm.py", beam_t["f32"]
    attn_by_path = dict(
        launches_serving=launches["attention_core"],
        launches_kd=kd_launches["attention_core"],
        launches_beam=beam_launches["attention_core"],
        launches_compact_kd=ckd_launches["attention_core"],
        launches_enhanced_serving=e_launches["attention_core"],
        launches_enhanced_kd=ekd_launches["attention_core"],
        **{f"launches_{k}": d["attention_core"] for k, d in later.items()})

    def with_later(name, n):
        """A kernel's launches on its main path plus those of the disk
        pipeline, the teacher trainer, the optimized trainer, the demo twin
        and the reference-checkpoint phase."""
        more = {f"launches_{k}": d[name] for k, d in later.items()}
        return dict(n=n + sum(more.values()), **more)

    kernels = [
        entry("attention_core", "attention_core.cu", "pallas_attention.py:198",
              sum(attn_by_path.values()),
              attn_err, attn_t["vit"]["ms"], attn_t["vit"]["plain_ms"],
              attn_t["vit"]["bound"], attn_t["vit"]["sdpa_ms"],
              queued_ms=attn_t["vit"]["queued_ms"],
              library_queued_ms=attn_t["vit"]["sdpa_queued_ms"],
              hd48_max_abs_err=attn48_err,
              teacher_step_span_ms=teach_times["span_ms"],
              teacher_step_wall_ms=teach_times["wall_ms"],
              teacher_step_launches=teach_times["attention_launches_per_step"],
              teacher_train_plain_backward_ms=teach_times[
                  "plain_backward_ms_bf16"],
              teacher_train_plain_backward_f32_ms=teach_times[
                  "plain_backward_ms_f32"],
              teacher_train_plain_backward_queued_ms=teach_times[
                  "plain_backward_queued_ms_bf16"],
              teacher_train_plain_backward_f32_queued_ms=teach_times[
                  "plain_backward_queued_ms_f32"],
              by_shape={
                  n: {k: (v if k != "bound" else v[0]) for k, v in t.items()}
                  for n, t in attn_t.items()},
              **attn_by_path),
        entry("greedy_decode_compact", "greedy_decode_compact.cu",
              "pallas_greedy.py:214", err=cg_diff, ms=cg_ms, plain=cg_plain_ms,
              bound=greedy_compact_bound(*cg_ops),
              **with_later("greedy_decode_compact",
                          c_launches["greedy_decode_compact"]),
              bf16_rows_identical=f"{cg_rows}/{BATCH}",
              chain_floor_ms=floors["greedy_decode_compact"]["floor_ms"],
              chain=floors["greedy_decode_compact"],
              ptxas=usage["greedy_decode_compact"]),
        entry("compact_scan", "compact_scan.cu", f"{lstm}:680",
              err=cscan["err"], ms=cscan["ms"], plain=cscan["plain_ms"],
              bound=cscan["bound"],
              **with_later("compact_scan", ckd_launches["compact_scan"]),
              plain_backward_ms=cscan["bwd_plain_ms"],
              chain_floor_ms=floors["compact_scan"]["floor_ms"],
              chain=floors["compact_scan"], ptxas=usage["compact_scan"]),
        entry("enhanced_scan", "enhanced_scan.cu", "pallas_enhanced.py:219",
              ekd_launches["enhanced_scan"], escan["err"], escan["ms"],
              escan["plain_ms"], escan["bound"],
              plain_backward_ms=escan["bwd_plain_ms"],
              float32_max_abs_err=escan["f32_err"],
              plain_f64_vs_f32_max_abs_err=escan["floor"],
              float32_ms=escan["f32_ms"],
              chain_floor_ms=floors["enhanced_scan"]["floor_ms"],
              chain=floors["enhanced_scan"], ptxas=usage["enhanced_scan"]),
        entry("greedy_decode", "greedy_decode.cu", "pallas_greedy.py:258",
              err=greedy_diff, ms=greedy_ms, plain=greedy_plain_ms,
              bound=greedy_bound,
              **with_later("greedy_decode", launches["greedy_decode"]),
              bf16_rows_identical=f"{bf16_rows}/{BATCH}",
              chain_floor_ms=floors["greedy_decode"]["floor_ms"],
              chain=floors["greedy_decode"], ptxas=usage["greedy_decode"]),
        entry("decoder_scan", "decoder_scan.cu", f"{lstm}:267",
              err=scan["fwd_err"], ms=scan_t["eval_ms"],
              plain=scan_t["plain_eval_ms"], bound=scan_b["eval"],
              **with_later("decoder_scan", kd_launches["decoder_scan"]),
              chain_floor_ms=floors["decoder_scan"]["floor_ms"],
              chain=floors["decoder_scan"], ptxas=usage["decoder_scan"]),
        entry("decoder_scan_train", "decoder_scan.cu", f"{lstm}:339",
              err=scan["fwd_err"], ms=scan_t["train_ms"],
              plain=scan_t["plain_train_ms"], bound=scan_b["train"],
              **with_later("decoder_scan_train",
                          kd_launches["decoder_scan_train"]),
              chain_floor_ms=floors["decoder_scan"]["floor_ms"],
              ptxas=usage["decoder_scan"]),
        entry("decoder_scan_bwd", "decoder_scan_bwd.cu", f"{lstm}:1037",
              err=scan["bwd_err"], ms=scan_t["bwd_ms"],
              plain=scan_t["plain_bwd_ms"], bound=scan_b["bwd"],
              **with_later("decoder_scan_bwd", kd_launches["decoder_scan_bwd"]),
              chain_floor_ms=floors["decoder_scan_bwd"]["floor_ms"],
              chain=floors["decoder_scan_bwd"],
              ptxas=usage["decoder_scan_bwd"],
              recompute_ms=scan_t["bwd_stage0_ms"],
              chain_ms=scan_t["bwd_stage1_ms"],
              reductions_ms=scan_t["bwd_stage2_ms"],
              weights_ms=scan_t["bwd_weights_ms"]),
        entry("beam_self_attention", "beam_attention.cu",
              "pallas_beam_attn.py:166", err=beam_err["self"],
              ms=bt["self_ms"], plain=bt["self_plain_ms"],
              bound=bt["bounds"]["self"], library=bt["self_sdpa_ms"],
              **with_later("beam_self_attention",
                          beam_launches["beam_self_attention"]),
              queued_ms=bt["self_queued_ms"],
              library_queued_ms=bt["self_sdpa_queued_ms"],
              bf16_ms=beam_t["bf16"]["self_ms"],
              bf16_queued_ms=beam_t["bf16"]["self_queued_ms"],
              bf16_library_ms=beam_t["bf16"]["self_sdpa_ms"],
              bf16_library_queued_ms=beam_t["bf16"]["self_sdpa_queued_ms"],
              plan=BA.self_plan(BEAM_K, MAX_LEN - 1, torch.float32),
              ptxas=ptxas_usage("beam_attention", "beam_self_kernel")),
        entry("beam_cross_attention", "beam_attention.cu",
              "pallas_beam_attn.py:249", err=beam_err["cross"],
              ms=bt["cross_ms"], plain=bt["cross_plain_ms"],
              bound=bt["bounds"]["cross"], library=bt["cross_sdpa_ms"],
              **with_later("beam_cross_attention",
                          beam_launches["beam_cross_attention"]),
              queued_ms=bt["cross_queued_ms"],
              library_queued_ms=bt["cross_sdpa_queued_ms"],
              bf16_ms=beam_t["bf16"]["cross_ms"],
              bf16_queued_ms=beam_t["bf16"]["cross_queued_ms"]),
    ]
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"by {k['bound_by']}, {k['launches']} launches on its path")
    print(json.dumps({"kernels": kernels, "images_per_s": imgs_per_s,
                      "kd_images_per_s": kd_imgs_per_s,
                      "compact_images_per_s": c_rate,
                      "compact_kd_images_per_s": ckd_rate,
                      "enhanced_images_per_s": e_rate,
                      "enhanced_kd_images_per_s": ekd_rate,
                      "beam_images_per_s": beam_rates,
                      "beam_batch_ms": beam_split,
                      "disk_pipeline": disk_times,
                      "teacher_training": teach_times,
                      "teacher_card_vs_cpu": teach_both,
                      "optimized_kd": opt_times,
                      "optimized_card_vs_cpu": opt_both,
                      "pipeline_twin_s": pipe_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
