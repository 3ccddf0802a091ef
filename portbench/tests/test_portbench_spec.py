"""BENCHMARK.json against the contract's shapes, every cell and metric
resolving to its files by name, and a cell and a metric added by files
alone."""

import json
import re
import shutil

import pytest

from portbench import harness, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("portbench/configs/")
    cfg = spec.config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    traffic = spec.traffic(w["traffic"])
    entry = spec.entry(traffic["entry"])
    assert callable(entry.build) and callable(entry.control)
    assert set(traffic["limits"])
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in spec.metrics_of(BENCH, w["name"], kind)]
        assert names, kind
    assert "setup_s" in [m["name"] for m in
                         spec.metrics_of(BENCH, w["name"], "end_to_end")]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.metric_reader(m["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        moves = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        # every cell of a per-layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path, tiny):
    """A new traffic mix and a new metric reader as files, a new cell and
    metric as entries of BENCHMARK.json: no existing file changes."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "workloads", root / "workloads")
    shutil.copytree(spec.HERE / "metrics", root / "metrics")
    mix = spec.traffic("greedy_b256")
    (root / "workloads" / "greedy_b8.json").write_text(json.dumps(
        dict(mix, batch=8, pool=16)))
    (root / "metrics" / "calls_a_second.greedy.py").write_text(
        "def read(run):\n"
        "    return run.window['calls'] / run.window['seconds']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "full_greedy_b8",
                               "config": "full_student",
                               "traffic": "greedy_b8", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_a_second.greedy",
                               "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "greedy_images_per_s",
                               "workloads": ["full_greedy_b8"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("greedy_images_per_s", "greedy_batch_p95_ms"):
            m["workloads"].append("full_greedy_b8")
    over = tiny("full_greedy_b256", "float32")
    over["traffic_over"] = {k: v for k, v in over["traffic_over"].items()
                            if k not in ("batch", "pool")}
    out = harness.run_cell("full_greedy_b8", 5, 0.2, True, device="cpu",
                           bench=bench, root=root, **over)
    assert out["correct"]
    assert out["metrics"]["calls_a_second.greedy"]["value"] > 0
    assert out["attempted"] >= 1
