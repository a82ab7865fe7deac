"""Find a cell, its configuration, its traffic and its metrics by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"
#: Cells the benchmark does not run (PERF.md says why), each a file of the
#: entries that would add it to BENCHMARK.json.
SHELVED_DIR = BENCH_DIR / "shelved"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with what its names point to."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_spec(path: pathlib.Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def with_shelved(spec: dict) -> dict:
    """``spec`` and the entries of every shelved cell: the CPU tests and
    the control still run those cells, which come back to the benchmark
    by their entries alone."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in spec.items()}
    for path in sorted(SHELVED_DIR.glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            out[key] = out[key] + entries
    return out


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """A metric with ``workloads`` applies to the cells listed; a
    per-layer one without it to every cell reporting what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec if spec is not None else load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, per_layer)


def load_file_module(path: pathlib.Path, name: str) -> ModuleType:
    """Import one file of the benchmark by its path (names may hold
    dots, which a plain import cannot)."""
    mod_name = f"port_bench._files.{name}"
    mod = sys.modules.get(mod_name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(config: dict) -> ModuleType:
    name = config["driver"]
    return load_file_module(BENCH_DIR / "drivers" / f"{name}.py",
                            f"drivers.{name}")


def reference(config: dict) -> ModuleType:
    name = config["reference"]
    return load_file_module(BENCH_DIR / "reference" / f"{name}.py",
                            f"reference.{name}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, else the reader of the quantity the name
    splits by cell kind: ``majx_roofline.serve`` -> ``majx_roofline.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        name = name.split(".")[0]
        path = BENCH_DIR / "metrics" / f"{name}.py"
    return load_file_module(path, f"metrics.{name}")
