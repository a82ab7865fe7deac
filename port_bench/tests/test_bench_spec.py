"""BENCHMARK.json against the benchmark's contract, and every cell and
metric found by name in the benchmark's data files."""

from __future__ import annotations

import json
import re

import pytest

from port_bench.tests._util import ROOT  # noqa: F401  (sets the path)
from port_bench.harness import spec as specs

SPEC = specs.load_spec()
#: The shelved cells' entries are held to the same rules, so that they can
#: come back as they are.
FULL = specs.with_shelved(SPEC)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in FULL["workloads"]]
METRICS = [m["name"] for m in FULL["end_to_end"] + FULL["per_layer"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = specs.load_cell(cell, FULL)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])
    assert (specs.BENCH_DIR / "drivers" /
            f"{c.config['driver']}.py").exists()
    assert (specs.BENCH_DIR / "reference" /
            f"{c.config['reference']}.py").exists()
    drv = specs.driver(c.config)
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(drv, fn))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    assert callable(specs.metric_reader(metric).read)


@pytest.mark.parametrize("entry", FULL["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and len(entry["reduced"]) <= 16
    assert entry["file"].startswith("port_bench/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in config
        assert not key.endswith(("_dim", "_rank", "words"))
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


@pytest.mark.parametrize("entry", FULL["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["config"] in {c["name"] for c in FULL["configs"]}
    assert 1 <= len(entry["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in FULL["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


@pytest.mark.parametrize("entry", FULL["end_to_end"] + FULL["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    if "bound" in entry:
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    else:
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert 1 <= len(entry["layer"]) <= 200
    for cell in entry.get("workloads", ()):
        assert cell in CELLS
    if entry["name"].split(".")[0].endswith("_roofline"):
        assert entry["unit"] == "%"


def test_names_unique():
    for group in (CELLS, METRICS, [c["name"] for c in FULL["configs"]]):
        assert len(group) == len(set(group))
