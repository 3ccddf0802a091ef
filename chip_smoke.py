#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Imports nothing of JAX.  In order it:
  1. prints the card and its power limit, and exits non-zero without a card;
  2. builds every kernel of the serving path from ``csrc/`` (one nvcc per
     source, started together);
  3. turns TF32 off, so the float32 comparisons are real float32;
  4. holds the attention-core kernel against its plain version at the
     refinement and ViT shapes, causal and not, float32 and bf16;
  5. holds the greedy-decode kernel against its plain version at full width
     (B=32, L=49, E=256, H=512, V=2994, T=20), temperature 1 and 2;
  6. drives the main path: a full student from a numpy seed is written as a
     JAX-format checkpoint, reloaded through the serve path's loader in bf16,
     and captions 8 batches of 32 seeded uint8 224x224 images through
     ``make_greedy_captioner``, with both kernels' launch counts read around
     exactly that run; a float32 copy on the card is held against the
     all-plain CPU path on 4 images;
  7. prints kernel and plain times (CUDA events, median after warm-up) and
     the end-to-end images/s;
  8. prints the kernels JSON line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import full_student_config
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.vocabulary import (END, PAD, SPECIALS,
                                                      Vocabulary)
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import student_init
from imagecaptioner_tpu_torch.ops import _build
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops.decode import tokens_to_caption
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint

VOCAB = 2994          # bench.py's serving point
BATCH, N_BATCHES, MAX_LEN = 32, 8, 20
SEED = 0
ATTN_SHAPES = [(32, 4, 49, 64), (16, 6, 197, 64)]  # refinement MHA, ViT MHSA
ATTN_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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

    secs = _build.build_all()
    print(f"built {', '.join(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # --- 4. attention kernel vs plain ---------------------------------
    attn_err, attn_ms, attn_plain_ms = check_attention(dev, gen)

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

    # --- 6. the main path: serve loader -> captioner, bf16 --------------
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
    print(f"main path launches: {launches}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
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

    # --- 7./8. timings and the result lines ------------------------------
    print(f"attention_core (32,4,49,64) bf16: kernel {attn_ms:.4f} ms, "
          f"plain {attn_plain_ms:.4f} ms")
    print(f"greedy_decode B=32 T=20 bf16: kernel {greedy_ms:.4f} ms, "
          f"plain {greedy_plain_ms:.4f} ms")
    kernels = [
        {"name": "attention_core", "route": "cuda",
         "source": "imagecaptioner_tpu_torch/csrc/attention_core.cu",
         "replaces": "imagecaptioner_tpu/ops/pallas_attention.py:198",
         "launches": launches["attention_core"], "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms},
        {"name": "greedy_decode", "route": "cuda",
         "source": "imagecaptioner_tpu_torch/csrc/greedy_decode.cu",
         "replaces": "imagecaptioner_tpu/ops/pallas_greedy.py:258",
         "launches": launches["greedy_decode"], "max_abs_err": greedy_diff,
         "bf16_rows_identical": f"{bf16_rows}/{BATCH}",
         "ms": greedy_ms, "plain_ms": greedy_plain_ms},
    ]
    print(json.dumps({"kernels": kernels, "images_per_s": imgs_per_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
