"""KD pipeline of the port (the twin of the root ``run_kd_pipeline.py``):
prerequisite checks (teacher checkpoint, captions CSV, Images directory,
the packages the port needs), then the port's KD trainer and its
student-vs-teacher evaluator as subprocesses on ``--device``, then the
artifact list.

  python -m imagecaptioner_tpu_torch.runners.run_kd_pipeline \\
      [--data-root data/flickr8k] [--teacher-checkpoint ...] \\
      [--output-dir saved_models] [--epochs N] [--student full|compact|enhanced] \\
      [--max-samples 100] [--skip-eval] [--device cuda|cpu]

Exits 1 when a prerequisite is missing or a step fails.  The subprocesses
run in the caller's directory (the evaluator writes
``student_vs_teacher_report.json`` there) with this package importable.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
from typing import List

from imagecaptioner_tpu_torch.core.device import resolve_device

# the directory that holds the package
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = ("best_student_model.npz", "final_student_model.npz",
             "student_training_history.json", "vocab.json")
REPORT = "student_vs_teacher_report.json"


def package_env() -> dict:
    """The environment with this package's directory first on
    ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def check_prerequisites(teacher_ckpt: str, data_root: str,
                        captions_file: str) -> bool:
    ok = True
    for path, what in [(teacher_ckpt, "teacher checkpoint"),
                       (captions_file, "captions CSV"),
                       (os.path.join(data_root, "Images"),
                        "Images directory")]:
        if os.path.exists(path):
            print(f"  [ok] {what}: {path}")
        else:
            print(f"  [MISSING] {what}: {path}")
            ok = False
    for pkg in ("torch", "numpy"):
        try:
            importlib.import_module(pkg)
            print(f"  [ok] package {pkg}")
        except ImportError:
            print(f"  [MISSING] package {pkg}")
            ok = False
    return ok


def run_command(argv: List[str], description: str) -> bool:
    print(f"\n{'=' * 60}\n{description}\n{'=' * 60}", flush=True)
    result = subprocess.run([sys.executable, "-m", *argv], env=package_env())
    if result.returncode != 0:
        print(f"FAILED (exit {result.returncode}): {description}")
        return False
    return True


def pipeline_commands(args, captions: str) -> List[List[str]]:
    """The trainer's command line, then (unless ``--skip-eval``) the
    evaluator's, each after ``python -m``."""
    kd = ["imagecaptioner_tpu_torch.train.train_student_kd",
          "--data-root", args.data_root, "--captions-file", captions,
          "--teacher-checkpoint", args.teacher_checkpoint,
          "--output-dir", args.output_dir, "--student", args.student,
          "--device", args.device]
    if args.epochs is not None:
        kd += ["--epochs", str(args.epochs)]
    if args.skip_eval:
        return [kd]
    return [kd, ["imagecaptioner_tpu_torch.eval.evaluate_student",
                 "--student-checkpoint",
                 os.path.join(args.output_dir, "best_student_model.npz"),
                 "--teacher-checkpoint", args.teacher_checkpoint,
                 "--vocab", os.path.join(args.output_dir, "vocab.json"),
                 "--data-root", args.data_root, "--captions-file", captions,
                 "--max-samples", str(args.max_samples),
                 "--device", args.device]]


def artifacts(args) -> List[str]:
    """The files the pipeline lists at its end."""
    out = [os.path.join(args.output_dir, name) for name in ARTIFACTS]
    return out if args.skip_eval else out + [REPORT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the full KD pipeline")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--student", default="full",
                    choices=["full", "compact", "enhanced"])
    ap.add_argument("--max-samples", type=int, default=100)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    captions = args.captions_file or os.path.join(args.data_root,
                                                  "captions_clean.csv")

    print("Checking prerequisites...")
    if not check_prerequisites(args.teacher_checkpoint, args.data_root,
                               captions):
        print("\nPrerequisites not met — aborting.")
        return 1
    titles = ("Step 1/2: Knowledge-distillation training",
              "Step 2/2: Student-vs-teacher evaluation")
    for cmd, title in zip(pipeline_commands(args, captions), titles):
        if not run_command(cmd, title):
            return 1

    print(f"\n{'=' * 60}\nPipeline complete. Artifacts:")
    for p in artifacts(args):
        print(f"  {'[ok]' if os.path.exists(p) else '[missing]'} {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
