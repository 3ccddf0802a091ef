"""On the card: every cell of BENCHMARK.json runs briefly through the
command and comes out correct, traced and not."""

import json
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests import test_portbench_reference as REF

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, trace, card):
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000001", "--seconds", "3", "--trace", str(trace)],
        cwd=spec.REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    """The control at the cell's own size fails a limit on three seeds."""
    from portbench import calibrate, harness
    limits = harness.make_context(cell, 0, "cuda").traffic["limits"]
    for seed in (3000000011, 3000000012, 3000000013):
        r = calibrate.readings(cell, seed, "control", 2)
        assert any(r[k] > lim for k, lim in limits.items()), (seed, r)


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in REF.FAULTS[c]])
def test_fault_is_not_correct_at_the_cells_size(cell, fault, card):
    """A run at the cell's own size with the timed path broken underneath
    comes out not correct, on the number named for the fault."""
    from portbench import faults, harness
    with faults.FAULTS[fault]():
        out = harness.run_cell(cell, 3000000021, 2.0, False,
                               log=lambda s: None)
    assert not out["correct"], out["check"]
    number = out["check"][REF.FAULTS[cell][fault]]
    assert number["value"] > number["limit"], out["check"]
