"""BENCHMARK.json against the contract's shapes: keys, names, units,
lengths, bounds, cells and the check's time budget."""
import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
NAME = spec.NAME_RE
UNIT = spec.UNIT_RE
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    widths = ("hidden_size", "intermediate_size", "ffn_dim", "head_dim",
              "num_experts_per_tok")
    assert not any(k in widths or k.endswith(("_dim", "_rank"))
                   for k in entry["reduced"])


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert work["chips"] in (1, 4) and _line(work["why"])
    assert work["config"] in {c["name"] for c in BENCH["configs"]}


def test_cells_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert 1 <= len(CELLS) <= 24


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_unique_and_setup_present():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(BENCH["end_to_end"]) <= 16 and len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if spec.applies(m, cell)]
    per = [m for m in BENCH["per_layer"] if spec.applies(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in per:
        assert m["moves"] in {x["name"] for x in e2e}


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(spec.ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_bench_file_is_plain_json():
    raw = (spec.ROOT / "BENCHMARK.json").read_text()
    assert json.loads(raw) == BENCH
