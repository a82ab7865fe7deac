"""Shared by the benchmark's CPU tests: the import path and small sizes."""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: Cells at a size a CPU test run holds: 64 words a row, and the ops
#: dealt from a deck of one of each, so the few requests a CPU finishes in
#: a short window hold every op.
SMALL = {"config": {"bank_words": 16, "banks": 4, "words": 64},
         "traffic": {"deck_copies": 1}}
SEED = 2**33 + 12345


def spec_and_shelved() -> dict:
    """BENCHMARK.json with the shelved cells' entries."""
    from port_bench.harness import spec

    return spec.with_shelved(spec.load_spec())


def cells_of(driver: str) -> list[str]:
    """The cells, shelved ones too, whose configuration runs ``driver``."""
    from port_bench.harness import spec

    full = spec_and_shelved()
    return [w["name"] for w in full["workloads"]
            if spec.load_cell(w["name"], full).config["driver"] == driver]
