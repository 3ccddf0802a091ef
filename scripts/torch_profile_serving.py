#!/usr/bin/env python3
"""Where one greedy serving batch of the PyTorch/CUDA port spends its time on
the GPU.

    python3 scripts/torch_profile_serving.py [--student full|compact|enhanced] \\
        [--batches 5] [--int8 [--int8-calibrate N]] [--out serving_profile.json]

Builds the student at full width from a numpy seed (random weights) in bf16,
captions batches of 32 seeded uint8 224x224 images through
``make_greedy_captioner`` (V=2994, 20 steps), and reports the untraced
batch's wall time (host clock; each call ends in a device-to-host copy), the
device time by kind of kernel from ``torch.profiler`` over the same number
of traced batches, and from it the card's busy share of an untraced batch.

With ``--int8`` the student serves through ``serve.int8_serving_copy`` with
its encoder int8 (``--int8-calibrate N``: static activation scales
calibrated on N seeded images, as the serve CLI's flag); the report then
also gives the activation quantization's device time and launches a batch
(every kernel launched inside ``ops/quant._quantize_activation``, found by
the launches' correlation ids in the CUDA trace), split into the
quantization kernel (#12) and anything else (plain PyTorch passes).

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
from imagecaptioner_tpu_torch.core import profiling as PP  # noqa: E402
from imagecaptioner_tpu_torch.core.modules import cast_parameters  # noqa: E402
from imagecaptioner_tpu_torch.eval import serve  # noqa: E402
from imagecaptioner_tpu_torch.models.student import Student, student_init  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import quant as Q  # noqa: E402
from imagecaptioner_tpu_torch.utils import convert as CV  # noqa: E402

VOCAB, BATCH, MAX_LEN, SEED = 2994, 32, 20, 0

QUANT_RANGE = "int8 activation quantization"


def traced_quantization(events, n_batches: int) -> dict:
    """Device time (ms) and launches a batch of what was launched inside
    ``QUANT_RANGE`` (``core/profiling.launched_within``): kernel #12, the
    memsets of its amax slots, and anything else (plain passes)."""
    q = PP.launched_within(events, lambda n: n == QUANT_RANGE, n_batches)
    out = {f"{key}_{what}": 0.0 for key in ("kernel", "memset", "plain")
           for what in ("ms", "launches")}
    out["spans"] = q["spans_per_run"]
    for d in q["by_kind"]:
        key = {"#12 int8 quantization": "kernel",
               "copies (memset)": "memset"}.get(d["kind"], "plain")
        out[f"{key}_ms"] += d["dur_us_per_run"] / 1e3
        out[f"{key}_launches"] += d["count_per_run"]
    return out


def traced_quantize_activation():
    """``ops/quant._quantize_activation`` inside a named profiler range."""
    real = Q._quantize_activation

    def traced(*args, **kw):
        with torch.profiler.record_function(QUANT_RANGE):
            return real(*args, **kw)
    Q._quantize_activation = traced


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--student", default="full", choices=sorted(STUDENT_CONFIGS))
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--int8", action="store_true",
                    help="serve with the student's encoder int8")
    ap.add_argument("--int8-calibrate", type=int, default=0, metavar="N",
                    help="with --int8: static scales from N seeded images")
    ap.add_argument("--out", default="serving_profile.json")
    args = ap.parse_args()
    if args.int8_calibrate and not args.int8:
        ap.error("--int8-calibrate needs --int8")
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    arm = ("int8" + (f" calibrated on {args.int8_calibrate}"
                     if args.int8_calibrate else "")) if args.int8 else "bf16"
    print(f"device: {smi}; student: {args.student}; encoder {arm}",
          flush=True)
    _build.build_all()

    cfg = STUDENT_CONFIGS[args.student](VOCAB)
    p, s = student_init(SEED, cfg)
    student = Student(cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(p, s, cfg), strict=True)
    cast_parameters(student, torch.bfloat16)
    model = student.to(dev).eval()
    rng = np.random.default_rng(SEED + 1)
    batches = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
               for _ in range(args.batches)]
    if args.int8:
        cal = (rng.integers(0, 256, (args.int8_calibrate, 224, 224, 3),
                            dtype=np.uint8) if args.int8_calibrate else None)
        model = serve.int8_serving_copy(model, "student", int8=True,
                                        calibrate_images=cal, verbose=False)
        traced_quantize_activation()
    caption = serve.make_greedy_captioner(model, cfg, dev,
                                          max_length=MAX_LEN)

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
    events = PP.profiler_events(prof)
    traced_rows = PP.trace_rows(events, args.batches)
    by_kind = {d["kind"]: d["dur_us_per_run"] / 1e3
               for d in traced_rows["by_kind"]}
    by_name = {d["name"]: (d["dur_us_per_run"] / 1e3, d["count_per_run"])
               for d in traced_rows["by_name"]}
    device_ms = traced_rows["device_us_per_run"] / 1e3
    wall_ms = 1e3 * statistics.median(wall)
    print(f"untraced batch of {BATCH}: median {wall_ms:.3f} ms, min "
          f"{1e3 * min(wall):.3f}, max {1e3 * max(wall):.3f} "
          f"({BATCH / statistics.median(wall):.1f} images/s); traced batch "
          f"median {1e3 * statistics.median(traced):.3f} ms")
    if device_ms <= 0:
        print("the profiler saw no device time: kinds not measured")
    else:
        print(f"device time {device_ms:.3f} ms per batch (kernels and "
              f"copies) in {traced_rows['launches_per_run']:.0f} kernel "
              f"launches: busy {100 * device_ms / wall_ms:.1f}% of an "
              f"untraced batch; kernels cover "
              f"{100 * traced_rows['busy_share']:.1f}% of the traced "
              f"window's {traced_rows['span_us_per_run'] / 1e3:.3f} ms a "
              f"batch on the device")
        for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)")
        print("  the ten kernels that take the most device time a batch:")
        for key, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                   )[:10]:
            print(f"    {ms:.3f} ms in {n:.0f} launches: {key[:110]}")
    quant = traced_quantization(events, args.batches) if args.int8 else None
    if quant is not None:
        total = quant["kernel_ms"] + quant["memset_ms"] + quant["plain_ms"]
        print(f"activation quantization ({quant['spans']:.0f} layers a "
              f"batch): {total:.3f} ms a batch "
              f"({100 * total / max(device_ms, 1e-9):.1f}% of device time); "
              f"kernel #12 {quant['kernel_ms']:.3f} ms in "
              f"{quant['kernel_launches']:.0f} launches, memsets "
              f"{quant['memset_ms']:.3f} ms in {quant['memset_launches']:.0f}, "
              f"plain passes {quant['plain_ms']:.3f} ms in "
              f"{quant['plain_launches']:.0f} launches")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "student": args.student, "encoder": arm,
                   "quantization": quant,
                   "wall_ms": [1e3 * w for w in wall],
                   "device_ms_by_kind": by_kind,
                   "device_ms_by_kernel": {k: v[0] for k, v in by_name.items()},
                   "kernel_launches_per_batch":
                       traced_rows["launches_per_run"],
                   "busy_share_of_window": traced_rows["busy_share"],
                   "window_ms": traced_rows["span_us_per_run"] / 1e3}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
