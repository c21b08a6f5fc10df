"""BENCHMARK.json and every file it names: present, loadable, and within the
benchmark contract's limits on names, units, lengths and keys."""

import json
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1:] == ["benchmark/run.py"] and len(SPEC["command"]) <= 32
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_loads(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith("benchmark/")
    data = harness.read_json(ROOT / conf["file"])
    assert data["reduced"] == conf["reduced"] == []
    assert data["family"] and (ROOT / "benchmark" / "families" / f"{data['family']}.py").exists()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files_load(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] == 1
    c = harness.cell(cell["name"], 1, "cpu")
    assert (ROOT / "benchmark" / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.workload["limits"], "a cell compares at least one number"
    e2e = {m["name"] for m in harness.metrics_of(cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(cell["name"], "per_layer")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC[kind]]
    assert len(names) == len(set(names))
    for m in SPEC[kind]:
        assert set(m) - {"workloads"} == METRIC_KEYS[kind], m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"])
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
            mod = harness.reader(m["name"])
            assert callable(mod.read)


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_layers_named_alike():
    """Metrics of one layer carry its name letter for letter; each layer's
    name is a module path or the device."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert "device" in layers
    for layer in layers - {"device"}:
        assert re.search(r"\(.+\)$", layer), layer
