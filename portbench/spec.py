"""Find everything a cell needs by its name.

``BENCHMARK.json`` at the repository root names each cell's configuration
and traffic mix, and every metric.  The files behind the names:

* a configuration: the ``file`` its entry in ``BENCHMARK.json`` gives
  (``portbench/configs/<name>.json``);
* a traffic mix: ``portbench/workloads/<traffic>.json``, whose ``entry``
  names its driver, ``portbench/entries/<entry>.py``;
* a metric: ``portbench/metrics/<metric name>.py``, a reader with a
  ``read(run)`` function.

A new cell or metric is new files and new entries in ``BENCHMARK.json``;
no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {what} name: {name!r}")
    return name


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == _checked(name, "workload"):
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == _checked(name, "config"):
            with open(REPO / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Optional[Path] = None) -> dict:
    path = (root or HERE) / "workloads" / f"{_checked(name, 'traffic')}.json"
    with open(path) as f:
        return json.load(f)


def entry(name: str) -> ModuleType:
    return importlib.import_module(
        f"portbench.entries.{_checked(name, 'entry')}")


def metric_reader(name: str, root: Optional[Path] = None) -> ModuleType:
    """``portbench/metrics/<name>.py`` as a module (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = (root or HERE) / "metrics" / f"{_checked(name, 'metric')}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads`` or list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def readers(bench: dict, cell_name: str, kind: str,
            root: Optional[Path] = None) -> Dict[str, ModuleType]:
    return {m["name"]: metric_reader(m["name"], root)
            for m in metrics_of(bench, cell_name, kind)}
