#!/usr/bin/env python3
"""Where one greedy serving batch of the PyTorch/CUDA port spends its time on
the GPU.

    python3 scripts/torch_profile_serving.py [--student full|compact|enhanced] \\
        [--batches 5] [--out serving_profile.json]

Builds the student at full width from a numpy seed (random weights) in bf16,
captions batches of 32 seeded uint8 224x224 images through
``make_greedy_captioner`` (V=2994, 20 steps), and reports the untraced
batch's wall time (host clock; each call ends in a device-to-host copy), the
device time by kind of kernel from ``torch.profiler`` over the same number
of traced batches, and from it the card's busy share of an untraced batch.

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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from imagecaptioner_tpu_torch.core.config import STUDENT_CONFIGS  # noqa: E402
from imagecaptioner_tpu_torch.core.modules import cast_parameters  # noqa: E402
from imagecaptioner_tpu_torch.eval import serve  # noqa: E402
from imagecaptioner_tpu_torch.models.student import Student, student_init  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.utils import convert as CV  # noqa: E402

VOCAB, BATCH, MAX_LEN, SEED = 2994, 32, 20, 0

# kernel-name fragments -> kind, first match wins
KINDS = [
    ("greedy decode kernel", ("greedy_kernel", "greedy_compact_kernel")),
    ("attention kernel", ("attention_kernel",)),
    ("copies", ("memcpy", "memset")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bnorm")),
    ("convolution (cuDNN)", ("cudnn", "conv", "fprop", "implicit", "winograd",
                             "nchw", "nhwc")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "cublas", "xmma")),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f in low for f in frags):
            return kind
    return "elementwise, reductions, softmax, other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--student", default="full", choices=sorted(STUDENT_CONFIGS))
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--out", default="serving_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; student: {args.student}", flush=True)
    _build.build_all()

    cfg = STUDENT_CONFIGS[args.student](VOCAB)
    p, s = student_init(SEED, cfg)
    student = Student(cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(p, s, cfg), strict=True)
    cast_parameters(student, torch.bfloat16)
    caption = serve.make_greedy_captioner(student.to(dev).eval(), cfg, dev,
                                          max_length=MAX_LEN)
    rng = np.random.default_rng(SEED + 1)
    batches = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
               for _ in range(args.batches)]

    def run():
        times = []
        for b in batches:
            t0 = time.perf_counter()
            caption(b)
            times.append(time.perf_counter() - t0)
        return times

    run()                                                   # warm-up
    wall = run()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = run()
    by_kind, n_kernels = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or \
            getattr(ev, "self_cuda_time_total", 0)
        is_dev = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev_us <= 0 or not is_dev:
            continue
        k = kind_of(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / args.batches
        n_kernels += ev.count
    device_ms = sum(by_kind.values())
    wall_ms = 1e3 * statistics.median(wall)
    print(f"untraced batch of {BATCH}: median {wall_ms:.3f} ms, min "
          f"{1e3 * min(wall):.3f}, max {1e3 * max(wall):.3f} "
          f"({BATCH / statistics.median(wall):.1f} images/s); traced batch "
          f"median {1e3 * statistics.median(traced):.3f} ms")
    if device_ms <= 0:
        print("the profiler saw no device time: kinds not measured")
    else:
        print(f"device time {device_ms:.3f} ms per batch in "
              f"{n_kernels / args.batches:.0f} kernel launches: busy "
              f"{100 * device_ms / wall_ms:.1f}% of an untraced batch")
        for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "student": args.student,
                   "wall_ms": [1e3 * w for w in wall],
                   "device_ms_by_kind": by_kind,
                   "kernel_launches_per_batch": n_kernels / args.batches}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
