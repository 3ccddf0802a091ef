#!/usr/bin/env python3
"""Where one teacher train step of the PyTorch/CUDA port spends its time on
the GPU.

    python3 scripts/torch_profile_teacher_step.py [--steps 3] \\
        [--out teacher_profile.json]

Builds the ViT-S/16 + 512/8/4 teacher at full width from a numpy seed
(random weights, V=2994), takes warm-up steps on in-memory grid data with the
teacher trainer's defaults (A=3 x B=12, T=47, bf16 compute, dropout 0.15,
TEACHER_TRAIN_AUG; the ViT partly frozen), then reports:

  * the untraced step's wall time (host clock, synchronised) and its span
    on the device by CUDA events, over ``--steps``;
  * device time by kind of kernel from ``torch.profiler`` over the same
    number of traced steps, and from it the card's busy share of an untraced
    step;
  * the device time of kernel #2's plain recompute backward in the step:
    the kernels launched under autograd's ``_AttentionCoreBackward`` nodes
    in that trace, and, as a cross-check, the kernels of as many
    ``attention_core_grads`` calls at the ViT's shape, profiled alone.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from imagecaptioner_tpu_torch.core.config import (TeacherConfig,  # noqa: E402
                                                  TeacherTrainConfig)
from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders  # noqa: E402
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import attention as ATT  # noqa: E402
from imagecaptioner_tpu_torch.train import common, steps  # noqa: E402
from imagecaptioner_tpu_torch.utils import convert as CV  # noqa: E402
from torch_profile_kd_step import kind_of  # noqa: E402

VOCAB, T_STEPS, SEED = 2994, 47, 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="teacher_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    _build.build_all()

    tr = TeacherTrainConfig()
    A, B = tr.accumulation_steps, tr.batch_size
    cfg = TeacherConfig(vocab_size=VOCAB)
    teacher = Teacher(cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        teacher_init(SEED, cfg)), strict=True)
    state = steps.init_teacher_train_state(teacher.to(dev), cfg)
    step = steps.make_teacher_train_step(cfg, tr, compute_dtype=torch.bfloat16)
    loader, _, _ = make_grid_loaders(A * B * 2, image_size=224, seed=SEED,
                                     batch_size=B, max_caption_len=T_STEPS + 1)
    stacks = [steps.batch_to_device(b, dev)
              for b in common.stacked_batches(loader, A)]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def run(n):
        wall, span = [], []
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            loss = step(state, stacks[i % len(stacks)], 0.5, gen)["loss"]
            end.record()
            float(loss)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            span.append(start.elapsed_time(end))
        return wall, span

    run(3)                                                  # warm-up
    wall, span = run(args.steps)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced, _ = run(args.steps)
    by_kind, n_kernels, bwd_us = {}, 0, 0.0
    for ev in prof.key_averages():
        if "_AttentionCoreBackward" in ev.key:
            # inclusive: the kernels launched by the node and its children
            bwd_us = max(bwd_us, getattr(ev, "device_time_total", 0) or
                         getattr(ev, "cuda_time_total", 0))
        dev_us = getattr(ev, "self_device_time_total", 0) or \
            getattr(ev, "self_cuda_time_total", 0)
        is_dev = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev_us <= 0 or not is_dev:
            continue
        k = kind_of(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / args.steps
        n_kernels += ev.count
    device_ms = sum(by_kind.values())
    wall_ms = statistics.median(wall)
    bwd_in_step_ms = bwd_us / 1e3 / args.steps

    # the same backward alone: one call per ViT block and micro-batch
    n_calls = A * cfg.encoder_depth
    shape = (B, cfg.encoder_heads, cfg.num_tokens,
             cfg.encoder_dim // cfg.encoder_heads)
    gen_q = torch.Generator(device=dev).manual_seed(SEED + 1)
    q, k, v, g = (torch.randn(shape, device=dev, generator=gen_q
                              ).to(torch.bfloat16) for _ in range(4))
    for _ in range(3):
        ATT.attention_core_grads(q, k, v, g, scale=shape[3] ** -0.5)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof_bwd:
        for _ in range(n_calls):
            ATT.attention_core_grads(q, k, v, g, scale=shape[3] ** -0.5)
        torch.cuda.synchronize()
    bwd_alone_ms = sum(
        (getattr(ev, "self_device_time_total", 0) or
         getattr(ev, "self_cuda_time_total", 0))
        for ev in prof_bwd.key_averages()
        if str(getattr(ev, "device_type", "")).endswith("CUDA")) / 1e3
    print(f"untraced step A={A} x B={B}: wall median {wall_ms:.3f} ms, min "
          f"{min(wall):.3f}, max {max(wall):.3f} "
          f"({A * B / wall_ms * 1e3:.1f} images/s); span by CUDA events "
          f"median {statistics.median(span):.3f} ms; traced step median "
          f"{statistics.median(traced):.3f} ms")
    if device_ms <= 0:
        print("the profiler saw no device time: kinds not measured")
    else:
        print(f"device time {device_ms:.3f} ms per step in "
              f"{n_kernels / args.steps:.0f} kernel launches: busy "
              f"{100 * device_ms / wall_ms:.1f}% of an untraced step")
        for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {kind}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)")
        print(f"#2's plain backward in the step (under "
              f"_AttentionCoreBackward): {bwd_in_step_ms:.3f} ms "
              f"({100 * bwd_in_step_ms / device_ms:.1f}% of device time); "
              f"{n_calls} calls of attention_core_grads at {shape} bf16 "
              f"alone: {bwd_alone_ms:.3f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "wall_ms": wall, "span_ms": span,
                   "traced_ms": traced, "device_ms": device_ms,
                   "kernels_per_step": n_kernels / args.steps,
                   "by_kind_ms": by_kind,
                   "attention_backward_in_step_ms": bwd_in_step_ms,
                   "attention_backward_alone_ms": bwd_alone_ms,
                   "attention_backward_calls": n_calls}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
