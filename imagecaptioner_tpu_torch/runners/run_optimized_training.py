"""Optimized-training launcher of the port (the twin of the root
``run_optimized_training.py``): the device report, the prerequisite file
checks, then the optimized trainer in this process.

  python -m imagecaptioner_tpu_torch.runners.run_optimized_training \\
      [--data-root data/flickr8k] [--teacher-checkpoint ...] [--epochs N] \\
      [--student compact|full|enhanced] [--device cuda|cpu]

Exits 1 when a file is missing or training fails; without a card the
default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

import torch

from imagecaptioner_tpu_torch.core.device import resolve_device


def device_report(device: torch.device) -> str:
    if device.type == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        return f"Devices: {names} (CUDA {torch.version.cuda})"
    return "Devices: [cpu]"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Launch optimized KD training")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--student", default="compact",
                    choices=["compact", "full", "enhanced"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    captions = args.captions_file or os.path.join(args.data_root,
                                                  "captions_clean.csv")
    device = resolve_device(args.device)
    print(device_report(device))
    print(f"Default device: {device}")

    for path, what in [(args.teacher_checkpoint, "teacher checkpoint"),
                       (captions, "captions CSV"),
                       (os.path.join(args.data_root, "Images"), "Images dir")]:
        if not os.path.exists(path):
            print(f"Missing {what}: {path}")
            return 1

    try:
        from imagecaptioner_tpu_torch.train.train_student_kd_optimized import \
            train_student_with_kd_optimized

        train_student_with_kd_optimized(
            args.data_root, captions, args.teacher_checkpoint,
            args.output_dir, num_epochs=args.epochs,
            student_variant=args.student, device=device)
        print("\nExpected improvements vs the unoptimized trainer:")
        print("  ~1.5-2x faster epochs, ~2x faster convergence,")
        print("  ~3-4x student inference speedup vs teacher.")
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
