#!/usr/bin/env python3
"""Where one KD train step of the PyTorch/CUDA port spends its time on the GPU.

    python3 scripts/torch_profile_kd_step.py [--steps 3] [--out kd_profile.json] \\
        [--student full|compact|enhanced] [--optimized]

Builds the student (the full one by default), a ViT-S/16 teacher and the projectors at full width
from numpy seeds (random weights), takes warm-up steps on in-memory grid
data (A=2 x B=16, T=47, V=2994, bf16 compute, float32 teacher, the trainer's
dropout: 0.3 for the full student, the variant's default otherwise;
KD_TRAIN_AUG); with ``--optimized``, the optimized trainer's step instead
(``OptimizedKDTrainConfig``, images read at 256 and cropped to 224 with
``OPTIMIZED_KD_AUG``, the optimized loss at epoch 1, OneCycle at step 2 of
30, the variant's default dropout), then reports:

  * the untraced step's wall time (host clock, synchronised) over ``--steps``;
  * device time by kind of kernel from ``torch.profiler`` over the same
    number of traced steps, and from it the card's busy share of an untraced
    step;
  * CUDA-event times of one micro-batch's phases (teacher forward, student
    forward, loss, backward) and of the optimizer update.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from imagecaptioner_tpu_torch.core.config import (STUDENT_CONFIGS,  # noqa: E402
                                                  DistillConfig,
                                                  KDTrainConfig,
                                                  OptimizedDistillConfig,
                                                  OptimizedKDTrainConfig,
                                                  TeacherConfig)
from imagecaptioner_tpu_torch.data import transforms as T  # noqa: E402
from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders  # noqa: E402
from imagecaptioner_tpu_torch.distill import losses as DL  # noqa: E402
from imagecaptioner_tpu_torch.distill.projector import (  # noqa: E402
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.distill.wrapper import teacher_forward_for_kd  # noqa: E402
from imagecaptioner_tpu_torch.models.student import Student, student_init  # noqa: E402
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.train import common, steps  # noqa: E402
from imagecaptioner_tpu_torch.utils import convert as CV  # noqa: E402

VOCAB, A, B, T_STEPS, SEED = 2994, 2, 16, 47, 0

# kernel-name fragments -> kind, first match wins
KINDS = [
    # csrc/decoder_scan_bwd.cu: the recompute (prep, gemm), the cooperative
    # reverse chain and the post-loop reductions
    ("decoder scan backward (recompute, chain, reductions)",
     ("prep_kernel", "::gemm_kernel", "chain_kernel", "post_kernel")),
    ("decoder scan backward (weight grads)", ("weight_grad_kernel",
                                              "bias_grad_kernel")),
    # the three students' forward recurrences: scan_kernel,
    # compact_scan_kernel, enhanced_scan_kernel
    ("decoder scan forward", ("scan_kernel",)),
    ("attention kernel", ("attention_kernel",)),
    ("copies", ("memcpy", "memset")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bnorm")),
    ("convolution (cuDNN)", ("cudnn", "conv", "wgrad", "dgrad", "fprop",
                             "implicit", "winograd", "nchw", "nhwc")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "cublas", "xmma")),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f in low for f in frags):
            return kind
    return "elementwise, reductions, optimizer, other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="kd_profile.json")
    ap.add_argument("--student", default="full", choices=sorted(STUDENT_CONFIGS))
    ap.add_argument("--optimized", action="store_true",
                    help="the optimized trainer's step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; student: {args.student}; optimized: "
          f"{args.optimized}", flush=True)
    _build.build_all()

    tr = OptimizedKDTrainConfig() if args.optimized else KDTrainConfig()
    over = ({"dropout": tr.dropout}
            if args.student == "full" and not args.optimized else {})
    s_cfg = STUDENT_CONFIGS[args.student](VOCAB, **over)
    t_cfg = TeacherConfig(vocab_size=VOCAB)
    p, s = student_init(SEED, s_cfg)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(p, s, s_cfg),
                            strict=True)
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        teacher_init(SEED + 3, t_cfg)), strict=True)
    teacher.to(dev).eval()
    proj, _ = create_feature_projectors(
        SEED + 1, teacher_embed=t_cfg.embed_size,
        student_embed=s_cfg.embed_size, student_hidden=s_cfg.hidden_size)
    projectors = make_projectors(t_cfg.embed_size, s_cfg.embed_size,
                                 s_cfg.hidden_size)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                               strict=True)
    state = steps.init_train_state(student.to(dev), projectors.to(dev), s_cfg)
    if args.optimized:
        aug = dataclasses.replace(T.OPTIMIZED_KD_AUG, out_size=224)
        od = OptimizedDistillConfig()
        step = steps.make_kd_train_step(
            teacher, t_cfg, s_cfg, None, tr, aug=aug,
            compute_dtype=torch.bfloat16, optimized=True, od_cfg=od,
            onecycle_total_steps=30, others_scale=tr.others_lr_scale,
            others_wd=tr.others_weight_decay)
        sched_t, epoch = 2, 1

        def loss_fn(student_out, teacher_out, targets, lengths):
            return DL.optimized_distillation_loss(
                student_out, teacher_out, targets, od, epoch, lengths=lengths)
    else:
        aug = T.KD_TRAIN_AUG
        step = steps.make_kd_train_step(teacher, t_cfg, s_cfg,
                                        DistillConfig(), tr,
                                        compute_dtype=torch.bfloat16)
        sched_t, epoch = 0.5, 0

        def loss_fn(student_out, teacher_out, targets, lengths):
            return DL.distillation_loss(student_out, teacher_out, targets,
                                        DistillConfig(), lengths=lengths)
    loader, _, _ = make_grid_loaders(
        A * B * 2, image_size=256 if args.optimized else 224, seed=SEED,
        batch_size=B, max_caption_len=T_STEPS + 1)
    stacks = [steps.batch_to_device(b, dev)
              for b in common.stacked_batches(loader, A)]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def run(n):
        times = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(state, stacks[i % len(stacks)], sched_t, gen,
                       epoch)["total_loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    run(3)                                                  # warm-up
    wall = run(args.steps)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = run(args.steps)
    by_kind, n_kernels = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or \
            getattr(ev, "self_cuda_time_total", 0)
        is_dev = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev_us <= 0 or not is_dev:
            continue
        k = kind_of(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / args.steps
        n_kernels += ev.count
    device_ms = sum(by_kind.values())
    wall_ms = 1e3 * statistics.median(wall)
    print(f"untraced step: median {wall_ms:.3f} ms, min {1e3 * min(wall):.3f}, "
          f"max {1e3 * max(wall):.3f} ({A * B / statistics.median(wall):.1f} "
          f"images/s); traced step median "
          f"{1e3 * statistics.median(traced):.3f} ms")
    if device_ms <= 0:
        print("the profiler saw no device time: kinds not measured")
    else:
        print(f"device time {device_ms:.3f} ms per step in "
              f"{n_kernels / args.steps:.0f} kernel launches: busy "
              f"{100 * device_ms / wall_ms:.1f}% of an untraced step")
        for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)")

    # phases of one micro-batch, by CUDA events
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    batch = stacks[0]
    state.student.train()
    state.projectors.train()
    params = state.named_parameters()
    for q in params.values():
        q.grad = None
    torch.cuda.synchronize()
    marks[0].record()
    images = T.augment_and_normalize(batch["images"][0], aug, gen,
                                     dtype=torch.bfloat16)
    caps = batch["captions"][0]
    t_out = teacher_forward_for_kd(teacher, images, caps[:-1])
    marks[1].record()
    logits, feats, hid, _ = state.student(images, caps[:-1], generator=gen)
    projected = state.projectors["encoder"](
        t_out["encoder_features"], teacher_seq_len=t_cfg.num_tokens,
        student_seq_len=s_cfg.feature_tokens, generator=gen)
    marks[2].record()
    loss, _ = loss_fn(
        {"logits": logits, "encoder_features": feats, "hidden_states": hid},
        dict(t_out, encoder_features=projected), caps[1:],
        batch["lengths"][0])
    marks[3].record()
    loss.backward()
    marks[4].record()
    torch.cuda.synchronize()
    phases = {"augment + teacher forward": marks[0].elapsed_time(marks[1]),
              "student forward + projector": marks[1].elapsed_time(marks[2]),
              "loss": marks[2].elapsed_time(marks[3]),
              "backward": marks[3].elapsed_time(marks[4])}
    print("one micro-batch by CUDA events (device timeline, gaps included):")
    for k, ms in phases.items():
        print(f"  {k}: {ms:.3f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "student": args.student,
                   "optimized": args.optimized,
                   "wall_ms": [1e3 * w for w in wall],
                   "device_ms_by_kind": by_kind, "phases_ms": phases,
                   "kernel_launches_per_step": n_kernels / args.steps}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
