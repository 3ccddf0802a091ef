"""Each reference against the port on the CPU at test size (float32, where
the two must agree), each control coming out not correct, and each fault
planted under the timed path coming out not correct."""

import pytest

from portbench import calibrate, faults, harness

CELLS = ["full_greedy_b256", "teacher_beam_b512", "full_kd_a2b64"]
# the cell's numbers that float32 on both sides must keep near 0
EXACT = {"full_greedy_b256": {"token_gap_mean": 0.0},
         "teacher_beam_b512": {"score_gap": 1e-4, "best_shortfall": 1e-4,
                               "unended": 0.0, "unordered": 0.0},
         "full_kd_a2b64": {"loss_gap": 1e-5, "grad_gap": 1e-3,
                           "change_gap": 1e-2, "proj_dir_gap": 1e-3}}
# each fault planted under the timed path, and the number that catches it
FAULTS = {"full_greedy_b256": {"altered_token": "token_gap_mean",
                               "half_batch_greedy": "token_gap_mean"},
          "teacher_beam_b512": {"altered_beam_token": "score_gap",
                                "half_batch_beam": "best_shortfall",
                                "wrong_beams": "best_shortfall",
                                "reversed_ranking": "unordered"},
          "full_kd_a2b64": {"stale_state": "change_gap",
                            "half_batch": "proj_dir_gap"}}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_float32(cell, tiny):
    out = harness.run_cell(cell, 2**31 + 11, 0.2, False, device="cpu",
                           **tiny(cell, "float32"))
    assert out["correct"] and out["failed"] == 0
    for name, most in EXACT[cell].items():
        assert out["check"][name]["value"] <= most, (name, out["check"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell, tiny):
    """At test size the control (``calibrate.py``'s) reads above the
    program on a compared number; at the cell's own size it fails the
    limits (``test_portbench_card.py``: three times the program's largest
    reading and more, PERF.md)."""
    over = tiny(cell)
    ctl = calibrate.readings(cell, 2**31 + 12, "control", 2, "cpu", **over)
    prog = calibrate.readings(cell, 2**31 + 12, "program", 2, "cpu", **over)
    limits = harness.make_context(cell, 0, "cpu", **over).traffic["limits"]
    assert any(ctl[k] > 1.5 * prog[k] for k in limits), (ctl, prog)


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in CELLS for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, tiny):
    """At test size, in the cell's own precision: the fault comes out not
    correct, and the number named for it reads over its limit."""
    assert fault in faults.FAULTS
    with faults.FAULTS[fault]():
        out = harness.run_cell(cell, 2**31 + 13, 0.2, False, device="cpu",
                               **tiny(cell))
    assert not out["correct"], out["check"]
    number = out["check"][FAULTS[cell][fault]]
    assert number["value"] > number["limit"], out["check"]
