"""The result line's keys, the runs that must print no result, and the
guard against JAX loaded in the process."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, spec


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace, tiny):
    out = harness.run_cell("teacher_beam_b512", 2**31 + 21, 0.2, trace,
                           device="cpu", **tiny("teacher_beam_b512"))
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec.metrics_of(
        spec.load_benchmark(), "teacher_beam_b512", kind)}
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    json.dumps(out)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "full_greedy_b256",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result():
    r = _run(spec.REPO)
    assert r.returncode != 0 and not r.stdout.strip()


def test_benchmark_alone_no_result(tmp_path):
    """Only BENCHMARK.json and portbench/: the program is missing."""
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and not r.stdout.strip()


def test_jax_in_the_process_is_refused(monkeypatch, tiny):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell("full_greedy_b256", 2**31 + 22, 0.1, False,
                         device="cpu", **tiny("full_greedy_b256"))
