#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py             # the whole run
    python3 chip_smoke.py --mutation  # only: does the backward check catch a fault?

Imports nothing of JAX.  In order it:
  1. prints the card and its power limit, and exits non-zero without a card;
  2. builds every kernel from ``csrc/`` (one nvcc per source, started
     together);
  3. turns TF32 off (matmul and cuDNN), so float32 comparisons are float32;
  4. holds the attention-core kernel against its plain version at the
     refinement, ViT and teacher-decoder shapes (causal, and cross-attention
     with Lq != Lk), float32 and bf16, and its gradients under autograd
     against autograd through the plain version;
  5. holds the greedy-decode kernel against its plain version at full width
     (B=32, L=49, E=256, H=512, V=2994, T=20), temperature 1 and 2;
  6. holds the decoder-scan kernels against their plain versions at the KD
     shapes (T=47, B=16, L=49, E=256, H=512), float32 and bf16: the forward
     with a random dropout mask and residuals, and without either; the
     reverse-time backward with random dh_tops and dattns, all eleven
     gradients, each of which must be non-degenerate;
  7. drives the serving path: a full student from a numpy seed is written as
     a JAX-format checkpoint, reloaded through the serve path's loader in
     bf16, and captions 8 batches of 32 seeded uint8 224x224 images through
     ``make_greedy_captioner``; a float32 copy on the card is held against
     the all-plain CPU path on 4 images;
  8. drives the training path: a ViT-S/16 teacher from a numpy seed written
     as a JAX-format checkpoint, the in-memory grid data, and
     ``train_student_with_kd`` for 3 optimizer steps (A=2 x B=16, T=47, bf16
     compute, dropout 0.3, ``KD_TRAIN_AUG``) with its preflight and
     validation pass; then one float32 step on the card against the same
     step on the CPU with the plain versions (dropout off, augmentation off,
     B=4).  Each path's launch counts are set to 0 just before it and read
     just after;
  9. prints kernel, plain and library times (CUDA events, median after
     warm-up), each kernel's bound, and the end-to-end rates;
 10. prints the kernels JSON line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import dataclasses
import json
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
from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                  KDTrainConfig, TeacherConfig,
                                                  full_student_config)
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders
from imagecaptioner_tpu_torch.data.vocabulary import (END, PAD, SPECIALS,
                                                      Vocabulary)
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import teacher_init
from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops import lstm_scan as S
from imagecaptioner_tpu_torch.ops.decode import tokens_to_caption
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.train import train_student_kd as TK
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)

VOCAB = 2994          # bench.py's serving point
BATCH, N_BATCHES, MAX_LEN = 32, 8, 20
SEED = 0
ATTN_SHAPES = [(32, 4, 49, 64), (16, 6, 197, 64)]  # refinement MHA, ViT MHSA
# the teacher decoder's shapes in a KD step: (B, heads, Lq, Lk, causal)
ATTN_KD_SHAPES = [(16, 8, 47, 47, True), (16, 8, 47, 197, False)]
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


def check_attention(dev, gen):
    """Kernel vs plain at the slice's shapes; returns (max_abs_err at the
    main path's case, kernel ms, plain ms)."""
    main_err = None
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = (torch.randn(shape, device=dev, generator=gen
                                       ).to(dtype) for _ in range(3))
                scale = shape[3] ** -0.5
                got = A.attention_core_cuda(q, k, v, causal=causal, scale=scale)
                ref = A.attention_core_plain(q, k, v, causal=causal, scale=scale)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != ref.shape:
                    fail(f"attention {shape} {dtype}: dtype/shape contract")
                err = (got.float() - ref.float()).abs().max().item()
                ok = err <= ATTN_LIMIT[dtype]
                print(f"attention_core {shape} {str(dtype)[6:]} causal={causal}"
                      f": max_abs_err {err:.3e} (limit {ATTN_LIMIT[dtype]:g})"
                      f" {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail("attention kernel disagrees with its plain version")
                if shape == ATTN_SHAPES[0] and dtype == torch.bfloat16 \
                        and not causal:
                    main_err = err
    q, k, v = (torch.randn(ATTN_SHAPES[0], device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    kms = median_ms(lambda: A.attention_core_cuda(q, k, v, scale=0.125), 200)
    pms = median_ms(lambda: A.attention_core_plain(q, k, v, scale=0.125), 200)
    return main_err, kms, pms


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


def check_greedy(model32, feats32):
    """Kernel vs plain at full width; returns (max |token diff| over the
    float32 runs, bf16 rows identical, kernel ms, plain ms)."""
    B = feats32.shape[0]
    max_diff, bf16_rows = 0, B
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype).contiguous()
        w = G.greedy_operands(model32.decoder, dtype)
        f_proj = G.attention_feature_projection(w, feats)
        for temp in (1.0, 2.0):
            got = G.greedy_decode_cuda(w, feats, f_proj, max_length=MAX_LEN,
                                       temperature=temp)
            ref = G.greedy_decode_plain(w, feats, f_proj, max_length=MAX_LEN,
                                        temperature=temp)
            torch.cuda.synchronize()
            distinct = len({tuple(r) for r in ref.tolist()})
            ended = int((ref == PAD).any(dim=1).sum())
            if distinct < B // 2 or not 0 < ended < B:
                fail(f"greedy check has no power: {distinct} distinct rows, "
                     f"{ended} of {B} rows end")
            rows = int((got == ref).all(dim=1).sum())
            diff = int((got.long() - ref.long()).abs().max())
            need = B if dtype == torch.float32 else B - 1
            print(f"greedy_decode B={B} {str(dtype)[6:]} T={temp}: "
                  f"{rows}/{B} rows identical (need {need}); reference has "
                  f"{distinct} distinct rows, {ended} ending "
                  f"{'ok' if rows >= need else 'FAIL'}", flush=True)
            if rows < need:
                fail("greedy kernel disagrees with its plain version")
            if dtype == torch.float32:
                max_diff = max(max_diff, diff)
            else:
                bf16_rows = min(bf16_rows, rows)
    feats = feats32.to(torch.bfloat16).contiguous()
    w = G.greedy_operands(model32.decoder, torch.bfloat16)
    f_proj = G.attention_feature_projection(w, feats)
    kms = median_ms(lambda: G.greedy_decode_cuda(
        w, feats, f_proj, max_length=MAX_LEN), 20, 3)
    pms = median_ms(lambda: G.greedy_decode_plain(
        w, feats, f_proj, max_length=MAX_LEN), 10, 2)
    return max_diff, bf16_rows, kms, pms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(bytes_moved: float, flops: float, kind: str):
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate for their type."""
    by_bytes, by_ops = bytes_moved / HBM_BPS, flops / PEAK[kind]
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_attention_kd(dev, gen):
    """The teacher decoder's attention shapes (causal self-attention and
    cross-attention with Lq != Lk), kernel against plain; then the kernel
    under autograd at the refinement shape: its gradients against autograd
    through the plain version.  Returns the SDPA yardstick's ms at the
    refinement shape (timed here, used nowhere in the port)."""
    for (B, H, Lq, Lk, causal) in ATTN_KD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, H, Lq, 64), device=dev, generator=gen).to(dtype)
            k, v = (torch.randn((B, H, Lk, 64), device=dev, generator=gen
                                ).to(dtype) for _ in range(2))
            got = A.attention_core_cuda(q, k, v, causal=causal, scale=0.125)
            ref = A.attention_core_plain(q, k, v, causal=causal, scale=0.125)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= ATTN_LIMIT[dtype]
            print(f"attention_core ({B},{H},{Lq}x{Lk},64) {str(dtype)[6:]} "
                  f"causal={causal}: max_abs_err {err:.3e} (limit "
                  f"{ATTN_LIMIT[dtype]:g}) {'ok' if ok else 'FAIL'}", flush=True)
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
    shape = (KD_B, 4, 49, 64)
    for dtype in (torch.float32, torch.bfloat16):
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
    q, k, v = (torch.randn(ATTN_SHAPES[0], device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    return median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=0.125), 200)


def scan_operands(decoder, dev, dtype, seed):
    """The twelve operands of the decoder scan at the KD shapes, from a
    full-width decoder at its default init, seeded features, tokens and a
    keep-0.7 dropout mask, prepared as ``full_decoder_apply`` prepares them."""
    cfg = decoder_cfg()
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal(
        (KD_B, cfg.feature_tokens, cfg.embed_size)).astype(np.float32)
        ).to(dev).to(dtype)
    caps = torch.from_numpy(rng.integers(0, VOCAB, (KD_T, KD_B))).to(dev)
    keep = torch.from_numpy(rng.random((KD_T, KD_B, cfg.hidden_size)) < 0.7)
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


def rel_errs(names, got, ref):
    """[(name, max abs error, max abs of the reference)] per output."""
    out = []
    for n, g, r in zip(names, got, ref):
        out.append((n, (g.float() - r.float()).abs().max().item(),
                    r.float().abs().max().item()))
    return out


def report(what, rows, limit, floor=None):
    worst = 0.0
    for i, (n, err, top) in enumerate(rows):
        rel = err / top if top > 0 else float("inf")
        extra = "" if floor is None else \
            f"; plain f64-vs-f32 sums differ by {floor[i][1]:.3e}"
        ok = top > 0 and rel <= limit
        print(f"{what} {n}: max_abs_err {err:.3e}, largest value {top:.3e}, "
              f"relative {rel:.3e} (limit {limit:g}){extra} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if top <= 0:
            fail(f"{what} {n} is degenerate (all zero): the check has no power")
        if not ok:
            fail(f"{what}: the kernel disagrees with its plain version on {n}")
        worst = max(worst, err)
    return worst


def check_scan(decoder, dev, mutant=False):
    """Decoder-scan kernels against their plain versions at the KD shapes.
    Returns the operands and residuals at bf16 for the timings, and the
    largest absolute errors of the bf16 (main path) forward and backward."""
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
        if not mutant:
            fwd_err = report(f"decoder_scan {tag} train form",
                             rel_errs(fwd_names, got, ref), limit,
                             rel_errs(fwd_names, ref64, ref))
            report(f"decoder_scan {tag} eval form",
                   rel_errs(fwd_names[:2], got_e, ref_e), limit)
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
        if dtype == torch.bfloat16 and not mutant:
            kept = dict(ops=ops, nomask=nomask, res=res, dh=dh, da=da,
                        fwd_err=fwd_err, bwd_err=bwd_err)
    return kept


def time_scan(kept):
    """CUDA-event medians at bf16, the KD step's compute dtype."""
    ops, nomask, res, dh, da = (kept[k] for k in
                                ("ops", "nomask", "res", "dh", "da"))
    E, H = ops[0].shape[2], ops[7].shape[1]
    with torch.no_grad():
        t = dict(
            eval_ms=median_ms(lambda: S.decoder_scan_cuda(*nomask), 20, 3),
            train_ms=median_ms(lambda: S.decoder_scan_cuda(
                *ops, residuals=True), 20, 3),
            plain_eval_ms=median_ms(lambda: S.decoder_scan_plain(*nomask), 5, 2),
            plain_train_ms=median_ms(lambda: S.decoder_scan_plain(
                *ops, residuals=True), 5, 2),
            bwd_steps_ms=median_ms(lambda: S.decoder_scan_bwd_steps_cuda(
                res, dh, da), 20, 3),
            bwd_ms=median_ms(lambda: S.decoder_scan_bwd_cuda(res, dh, da),
                             20, 3),
            plain_bwd_ms=median_ms(lambda: S.decoder_scan_bwd_plain(
                res, dh, da), 3, 1))
        stores = S.decoder_scan_bwd_steps_cuda(res, dh, da)[2]
        t["bwd_weights_ms"] = median_ms(
            lambda: S.decoder_scan_bwd_weights_cuda(stores, E, H), 20, 3)
    return t


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


def pad_vocabulary(vocab, size):
    """Fill the grid vocabulary up to the serving point's size."""
    for i in range(len(vocab), size):
        vocab.itos[i] = f"tok{i}"
        vocab.stoi[f"tok{i}"] = i
    return vocab


def run_kd(dev, tmp):
    """The training path at full width through ``train_student_with_kd``;
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
    out = os.path.join(tmp, "kd_out")
    torch.cuda.synchronize()
    A.launches = S.launches_eval = S.launches_train = S.launches_bwd = 0
    t0 = time.perf_counter()
    state, s_cfg, _ = TK.train_student_with_kd(
        train_loader, val_loader, vocab, ckpt, out, num_epochs=1,
        compute_dtype=torch.bfloat16, seed=SEED, device=dev, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_core": A.launches,
                "decoder_scan": S.launches_eval,
                "decoder_scan_train": S.launches_train,
                "decoder_scan_bwd": S.launches_bwd}
    print(f"KD path launches: {launches} ({wall:.1f} s for the preflight, "
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
    print(f"KD history: train loss {hist['train_losses']}, val loss "
          f"{hist['val_losses']}, components "
          f"{ {k: v[0] for k, v in hist['loss_components'].items()} }")
    if not numbers or not np.isfinite(numbers).all():
        fail(f"a KD metric is not finite: {hist}")
    if int(final["optimizer_state_dict"]["step"]) != KD_STEPS:
        fail("the final checkpoint does not carry the optimizer step")

    # parameters of all three groups moved, frozen ones did not
    p0, s0 = student_init(SEED, s_cfg)
    start = CV.jax_student_to_state_dict(p0, s0, s_cfg)
    moved = {"encoder": 0, "decoder": 0, "others": 0}
    for name, q in state.student.named_parameters():
        same = torch.equal(q.detach().cpu(), start[name])
        if not q.requires_grad:
            if not same:
                fail(f"frozen parameter {name} moved")
            continue
        group = name.split(".")[0]
        moved[group if group in moved else "others"] += int(not same)
    stats_moved = not torch.equal(
        state.student.encoder.resnet.bn1.running_mean.cpu(),
        start["encoder.resnet.bn1.running_mean"])
    print(f"KD parameters moved per group: {moved}; frozen ones did not; "
          f"frozen batch-norm statistics updated: {stats_moved}", flush=True)
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
        t0 = time.perf_counter()
        metrics = step(state, batch, 0.5, gen)
        float(metrics["total_loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times[1:]    # the first repeats the warm-up of a fresh generator


def card_vs_cpu_step(dev, s_cfg, ckpt, train_loader):
    """One float32 KD step on the card (kernels) against the same step on
    the CPU (plain versions): dropout off, augmentation off, A=1, B=4."""
    cfg0 = dataclasses.replace(s_cfg, dropout=0.0)
    p0, s0 = student_init(SEED, cfg0)
    proj, _ = create_feature_projectors(
        SEED + 1, teacher_embed=512, student_embed=cfg0.embed_size,
        student_hidden=cfg0.hidden_size)
    stacked = next(iter(common.stacked_batches(train_loader, 1)))
    small = {"images": stacked["images"][:, :4],
             "captions": stacked["captions"][:, :, :4],
             "lengths": stacked["lengths"][:, :4]}
    results = {}
    for where in (dev, torch.device("cpu")):
        student = Student(cfg0)
        student.load_state_dict(CV.jax_student_to_state_dict(p0, s0, cfg0),
                                strict=True)
        projectors = make_projectors(512, cfg0.embed_size, cfg0.hidden_size)
        projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                                   strict=True)
        teacher, t_cfg = TK.load_teacher(ckpt, VOCAB, where)
        state = steps.init_train_state(student.to(where),
                                       projectors.to(where), cfg0)
        step = steps.make_kd_train_step(
            teacher, t_cfg, cfg0, DistillConfig(), KDTrainConfig(dropout=0.0),
            aug=T.AugmentConfig(), compute_dtype=torch.float32)
        before = (A.launches, S.launches_train, S.launches_bwd)
        with M.no_dropout():
            metrics = step(state, steps.batch_to_device(small, where), 0.0,
                           None)
        results[where.type] = {k: float(v) for k, v in metrics.items()}
        after = (A.launches, S.launches_train, S.launches_bwd)
        launched = tuple(y - x for x, y in zip(before, after))
        if where.type == "cuda" and min(launched) < 1:
            fail(f"the float32 card step missed a kernel: {launched}")
        if where.type == "cpu" and launched != (0, 0, 0):
            fail("the CPU step launched a kernel")
    return results


# Limits of the float32 card-vs-CPU step, relative.  Loss terms: the forward
# passes differ only in summation order (cuDNN and cuBLAS against the CPU's
# kernels, this repository's kernels against their plain versions).  The
# gradient norm gathers a ResNet-50 backward through train-mode batch norm
# at random weights, which amplifies float32 noise far more than the forward.
CARD_CPU_LOSS_LIMIT = 1e-4
CARD_CPU_GNORM_LIMIT = 1e-3


def run_mutation(dev) -> int:
    """Build a copy of the backward kernel that leaves out the dropout mask
    on layer 1's input gradient (``dh0 = dh0_c + (dgp1·W_ih1ᵀ) · mask``) and
    run the backward check on it: the check must fail.  The copy lives in a
    temporary directory; the repository's sources are not touched."""
    tmp = tempfile.mkdtemp(prefix="ic_mutant_")
    try:
        for f in _build.CSRC.glob("*.cu*"):
            shutil.copy(f, tmp)
        path = os.path.join(tmp, "decoder_scan_bwd.cu")
        src = open(path).read()
        good = "const float dh0 = dh0_s[j] + ta_s[j] * m;"
        if src.count(good) != 1:
            fail("the line to mutate was not found in decoder_scan_bwd.cu")
        open(path, "w").write(src.replace(good,
                                          "const float dh0 = dh0_s[j] + ta_s[j];"))
        _build.CSRC = type(_build.CSRC)(tmp)
        decoder = make_decoder(dev)
        try:
            check_scan(decoder, dev, mutant=True)
        except SystemExit:
            print("mutation run: the backward check caught the mutant "
                  "(no dropout mask on d(h0)): ok", flush=True)
            return 0
        print("mutation run: the mutant PASSED the backward check: the check "
              "has no power", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    secs = _build.build_all()
    print(f"built {', '.join(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # --- 4. attention kernel vs plain ---------------------------------
    attn_err, attn_ms, attn_plain_ms = check_attention(dev, gen)
    attn_sdpa_ms = check_attention_kd(dev, gen)

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
            model32, feats32)

    # --- 6. decoder-scan kernels vs plain, at the KD step's shapes --------
    scan = check_scan(make_decoder(dev), dev)
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
    captions = [tokens_to_caption(t, vocab) for t in toks]
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

    # --- 8. the training path: train_student_with_kd at full width --------
    with tempfile.TemporaryDirectory() as tmp:
        kd_launches, kd_state, s_cfg, t_ckpt, kd_loader = run_kd(dev, tmp)
        step_s = time_kd_steps(dev, kd_state, s_cfg, t_ckpt, kd_loader)
        both = card_vs_cpu_step(dev, s_cfg, t_ckpt, kd_loader)
    kd_imgs_per_s = KD_A * KD_B / statistics.median(step_s)
    print(f"KD step: {kd_imgs_per_s:.1f} images/s (bf16 compute, float32 "
          f"teacher, A={KD_A} x B={KD_B}, T={KD_T}, host clock incl. H2D); "
          f"per step ms: median {1e3 * statistics.median(step_s):.3f}, min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}", flush=True)
    for k in common.LOSS_NAMES + ("grad_norm",):
        g, c = both["cuda"][k], both["cpu"][k]
        rel = abs(g - c) / max(abs(c), 1e-12) if c else abs(g)
        limit = CARD_CPU_GNORM_LIMIT if k == "grad_norm" else CARD_CPU_LOSS_LIMIT
        ok = np.isfinite(g) and rel <= limit
        print(f"fp32 KD step card vs CPU {k}: {g:.7g} vs {c:.7g}, relative "
              f"{rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("the card's float32 KD step disagrees with the CPU's")

    # --- 9./10. timings, bounds and the result lines -----------------------
    print(f"attention_core (32,4,49,64) bf16: kernel {attn_ms:.4f} ms, "
          f"plain {attn_plain_ms:.4f} ms, SDPA {attn_sdpa_ms:.4f} ms")
    print(f"greedy_decode B=32 T=20 bf16: kernel {greedy_ms:.4f} ms, "
          f"plain {greedy_plain_ms:.4f} ms")
    print(f"decoder_scan T={KD_T} B={KD_B} bf16: eval form "
          f"{scan_t['eval_ms']:.4f} ms (plain {scan_t['plain_eval_ms']:.4f}), "
          f"train form {scan_t['train_ms']:.4f} ms (plain "
          f"{scan_t['plain_train_ms']:.4f})")
    print(f"decoder_scan_bwd T={KD_T} B={KD_B} bf16 residuals: "
          f"{scan_t['bwd_ms']:.4f} ms = reverse-time steps "
          f"{scan_t['bwd_steps_ms']:.4f} + weight gradients "
          f"{scan_t['bwd_weights_ms']:.4f} (plain {scan_t['plain_bwd_ms']:.4f})")
    bh, lq, d = 32 * 4, 49, 64
    attn_bound = bound_ms(4 * bh * lq * d * 2, 4 * bh * lq * lq * d, "bf16")
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

    lstm = "pallas_lstm.py"
    kernels = [
        entry("attention_core", "attention_core.cu", "pallas_attention.py:198",
              launches["attention_core"] + kd_launches["attention_core"],
              attn_err, attn_ms, attn_plain_ms, attn_bound, attn_sdpa_ms,
              launches_serving=launches["attention_core"],
              launches_kd=kd_launches["attention_core"]),
        entry("greedy_decode", "greedy_decode.cu", "pallas_greedy.py:258",
              launches["greedy_decode"], greedy_diff, greedy_ms,
              greedy_plain_ms, greedy_bound,
              bf16_rows_identical=f"{bf16_rows}/{BATCH}"),
        entry("decoder_scan", "decoder_scan.cu", f"{lstm}:267",
              kd_launches["decoder_scan"], scan["fwd_err"],
              scan_t["eval_ms"], scan_t["plain_eval_ms"], scan_b["eval"]),
        entry("decoder_scan_train", "decoder_scan.cu", f"{lstm}:339",
              kd_launches["decoder_scan_train"], scan["fwd_err"],
              scan_t["train_ms"], scan_t["plain_train_ms"], scan_b["train"]),
        entry("decoder_scan_bwd", "decoder_scan_bwd.cu", f"{lstm}:1037",
              kd_launches["decoder_scan_bwd"], scan["bwd_err"],
              scan_t["bwd_ms"], scan_t["plain_bwd_ms"], scan_b["bwd"],
              steps_ms=scan_t["bwd_steps_ms"],
              weights_ms=scan_t["bwd_weights_ms"]),
    ]
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"by {k['bound_by']}, {k['launches']} launches on its path")
    print(json.dumps({"kernels": kernels, "images_per_s": imgs_per_s,
                      "kd_images_per_s": kd_imgs_per_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
