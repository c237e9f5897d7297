"""Every cell's files are found by name, and say what BENCHMARK.json
says."""
import pytest

from perfbench.harness import judge, spec
from perfbench.harness.dims import from_arch

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    cell = spec.cell(name)
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["workload"]["config"]]
    assert cell["config"]["name"] == conf["name"]
    assert cell["config"]["source"] == conf["source"]
    assert sorted(cell["config"]["reduced"]) == sorted(conf["reduced"])
    assert set(cell["limits"]) == set(judge.NUMBERS)
    drv = spec.driver(cell["traffic"]["driver"])
    assert callable(drv.run) and callable(drv.as_run)
    from_arch(cell["config"]["arch"])


@pytest.mark.parametrize("name", CELLS)
def test_departures_cover_every_reduced_key(name):
    conf = spec.cell(name)["config"]
    for key in conf["reduced"]:
        assert key in conf["departures"], key


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(spec.reader(metric).read)


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


@pytest.mark.parametrize("path", sorted((spec.HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_files_name_a_driver(path):
    import json
    tr = json.loads(path.read_text())
    assert spec.NAME_RE.match(path.stem)
    assert callable(spec.driver(tr["driver"]).run)
    assert tr["batch"] % tr["microbatches"] == 0
    assert tr["compare_steps"] >= 3 and tr["traced_steps"] >= 1
