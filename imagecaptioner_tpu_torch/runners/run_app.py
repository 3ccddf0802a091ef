"""Demo launcher of the port (the twin of the root ``run_app.py``): checks
that the teacher checkpoint and vocabulary exist, then serves the demo
(``runners/streamlit_app.py``) with streamlit on port 8501.

  python -m imagecaptioner_tpu_torch.runners.run_app [--device cuda|cpu]

Exits 1 when an artifact is missing, and when streamlit is not installed,
with the one-shot CLI demo's command line.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.runners import streamlit_app
from imagecaptioner_tpu_torch.runners.run_kd_pipeline import package_env

REQUIRED = [streamlit_app.DEFAULT_CKPT, streamlit_app.DEFAULT_VOCAB]
CLI_DEMO = ("python -m imagecaptioner_tpu_torch.runners.streamlit_app "
            "path/to/image.ppm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Launch the demo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    missing = [p for p in REQUIRED if not os.path.exists(p)]
    if missing:
        print("Missing artifacts (train the teacher first):")
        for p in missing:
            print(f"  {p}")
        return 1
    if importlib.util.find_spec("streamlit") is None:
        print("streamlit not installed — use the CLI demo instead:")
        print(f"  {CLI_DEMO}")
        return 1
    subprocess.run(
        [sys.executable, "-m", "streamlit", "run", streamlit_app.__file__,
         "--server.port", "8501", "--", "--device", args.device],
        env=package_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
