"""A cell's files, found by the names in ``BENCHMARK.json``.

A workload names its configuration (``configs`` entry, whose ``file`` is
the configuration as run) and its traffic (``perfbench/traffic/<traffic>
.json``); the traffic names its driver (``perfbench/drivers/<driver>.py``)
and each metric its reader (``perfbench/metrics/<metric>.py``).  A cell's
correctness limits are ``perfbench/limits/<workload>.json``.  A later PR
adds a cell, a configuration, a mix or a metric as new files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: Dict[str, Any] = None,
         root: Path = ROOT) -> Dict[str, Any]:
    """Everything one cell needs: its workload entry, configuration file,
    traffic file, limits and the metrics that apply to it.  Raises
    ``KeyError`` for a workload the benchmark does not have."""
    bench = bench if bench is not None else benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return {
        "workload": work,
        "config": _load_json(root / conf["file"]),
        "traffic": _load_json(root / "perfbench" / "traffic"
                              / f"{work['traffic']}.json"),
        "limits": _load_json(root / "perfbench" / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def driver(kind: str) -> ModuleType:
    """``perfbench/drivers/<kind>.py``, imported by name."""
    if not NAME_RE.match(kind) or "." in kind or "-" in kind:
        raise ValueError(f"driver name {kind!r}")
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """``perfbench/metrics/<metric>.py``: its ``read(run)`` returns the
    metric's value, or None where the run has nothing to read."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: List[Dict[str, Any]], run: Any,
                 root: Path = ROOT) -> Dict[str, Dict[str, Any]]:
    """Each entry's reader over ``run``; a metric whose reader finds
    nothing is left out."""
    out = {}
    for m in entries:
        value = reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
