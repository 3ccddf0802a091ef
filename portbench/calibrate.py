#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process (set-up is long):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --what program|control|<fault> [--calls 8]

``program``: the port as the cell runs it; ``control``: the entry's
control (the port's own lower-precision path, or the reference in a lower
precision in the program's place); a fault of ``faults.py``: the port
broken underneath.  One JSON line a seed: each number the check compares.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import faults, harness, spec  # noqa: E402


def readings(name: str, seed: int, what: str, calls: int, device: str = "cuda",
             **over) -> dict:
    ctx = harness.make_context(name, seed, device, **over)
    entry = spec.entry(ctx.traffic["entry"])
    fault = faults.FAULTS[what]() if what in faults.FAULTS else \
        contextlib.nullcontext()
    with fault:
        unit = entry.build(ctx)
        if what == "control":
            checks = entry.control(unit, calls)
        else:
            for i in range(calls):
                unit.call(i)
            unit.finish()
            checks = unit.check()
    return {k: v for k, (v, _) in checks.items()} | {
        "failed": getattr(unit, "failed", 0),
        "worst": getattr(unit, "worst", None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program")
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.what, args.calls)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": int(s), "s": round(time.perf_counter() - t0, 2),
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
