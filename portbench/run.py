#!/usr/bin/env python3
"""Run one cell of the benchmark of ``imagecaptioner_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...   (the same, from the repository root)

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``check``, each number compared beside its limit
(also the last lines on standard error).  Exits 2 without a result when
the cell's CUDA devices are not there.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# transformers, where installed, would load JAX through flax without this
os.environ.setdefault("USE_FLAX", "0")
HERE = Path(__file__).resolve().parent
REPO = str(HERE.parent)
# run as a script, Python puts portbench/ first on the path, where its
# module names would shadow the standard library's (trace)
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
