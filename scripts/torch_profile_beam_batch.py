#!/usr/bin/env python3
"""Where one batch of teacher beam serving spends its time on the GPU.

    python3 scripts/torch_profile_beam_batch.py [--batches 3] [--dtype float32]
                                                [--out beam_profile.json]

Builds the ViT-S/16 + transformer-decoder teacher at full width from a numpy
seed exactly as ``chip_smoke.py`` does (random weights, cross-attention
scaled up and END bias raised so that beams finish at different steps),
loads it through the serve path's loader, and captions batches of 16 seeded
uint8 224x224 images through ``make_beam_captioner`` (K=5, max_length 20).
Reports:

  * the untraced batch's wall time (host clock, each call ends in
    device-to-host copies) over ``--batches``;
  * device time by kind of kernel from ``torch.profiler`` over the same
    number of traced batches, the kernel launches a batch, and from them the
    card's busy share of an untraced batch;
  * host-clock times of the phases of one batch (upload + normalize, ViT
    encode, memory K/V projection, decode loop, download), synchronised
    between phases.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.core import profiling as PP  # noqa: E402
from imagecaptioner_tpu_torch.data import transforms as T  # noqa: E402
from imagecaptioner_tpu_torch.eval import serve  # noqa: E402
from imagecaptioner_tpu_torch.models import transformer as TD  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import decode as D  # noqa: E402

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--out", default="beam_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()

    dtype = getattr(torch, args.dtype)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "teacher.npz")
        CS.write_beam_teacher(ckpt)
        teacher, cfg = serve.load_teacher(ckpt, dev, dtype)
    kw = dict(max_length=CS.MAX_LEN, beam_size=CS.BEAM_K)
    caption = serve.make_beam_captioner(teacher, cfg, dev, **kw)
    batches = CS.beam_images(args.batches, CS.SEED + 11)

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
    traced_rows = PP.trace_rows(PP.profiler_events(prof), args.batches)
    by_kind = {d["kind"]: d["dur_us_per_run"] / 1e3
               for d in traced_rows["by_kind"]}
    device_ms = traced_rows["device_us_per_run"] / 1e3
    wall_ms = 1e3 * statistics.median(wall)
    print(f"untraced batch ({args.dtype}, B={CS.BEAM_B}, K={CS.BEAM_K}, "
          f"T={CS.MAX_LEN}): median {wall_ms:.3f} ms, min "
          f"{1e3 * min(wall):.3f}, max {1e3 * max(wall):.3f} "
          f"({CS.BEAM_B / statistics.median(wall):.1f} images/s); traced batch "
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

    # phases of one batch on the host clock, synchronised between phases
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    phases = {}
    with torch.inference_mode():
        x, phases["upload + normalize"] = timed(lambda: T.normalize(
            torch.from_numpy(np.ascontiguousarray(batches[0])).to(dev),
            dtype=dtype))
        mem, phases["ViT encode"] = timed(lambda: teacher.encode_image(x))
        mem_kv, phases["memory K/V projection"] = timed(
            lambda: TD.precompute_memory_kv(teacher.decoder, mem,
                                            num_heads=cfg.num_heads))
        out, phases["decode loop"] = timed(
            lambda: D.beam_decode_packed_kv(teacher, mem_kv, **kw))
        _, phases["download"] = timed(
            lambda: tuple(t.cpu().numpy() for t in out))
    print("one batch by phase (host clock, synchronised):")
    for k, ms in phases.items():
        print(f"  {k}: {ms:.3f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "dtype": args.dtype,
                   "wall_ms": [1e3 * w for w in wall],
                   "device_ms_by_kind": by_kind, "phases_ms": phases,
                   "kernel_launches_per_batch":
                       traced_rows["launches_per_run"],
                   "busy_share_of_window": traced_rows["busy_share"],
                   "window_ms": traced_rows["span_us_per_run"] / 1e3}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
