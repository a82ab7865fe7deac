"""Print every figure's rows and the kernel benches as one CSV.

The counterpart of the reference's ``benchmarks/run.py``: prints
``name,us_per_call,derived``, the figures of
:mod:`repro_torch.paper.figures` in the reference's order, then
:mod:`repro_torch.paper.kernel_bench`, then one roofline row for each
``ok`` cell of the port's dry-run files
(``results/torch_dryrun_{single,multi,serve}.json``, as
:mod:`repro_torch.paper.run_all_cells` writes them; a file that is not
there is skipped, a malformed one raises).

Usage:
  python -m repro_torch.paper.run [--device cpu] [--root DIR]
      [--results DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.paper import figures, kernel_bench
from repro_torch.sweep import default_root

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: The port's dry-run files, by the names ``run_all_cells`` gives them.
DRYRUN_FILES = ("torch_dryrun_single.json", "torch_dryrun_multi.json",
                "torch_dryrun_serve.json")


def roofline_rows(path: str) -> list:
    """One row for each ``ok`` cell of the dry-run file at ``path``."""
    with open(path) as f:
        cells = json.load(f)
    if not isinstance(cells, list):
        raise ValueError(f"{path}: a dry-run file is a list of cells")
    rows = []
    for r in cells:
        if r.get("status") != "ok":
            continue
        try:
            rl = r["roofline"]
            rows.append((
                f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}", 0.0,
                f"bound={rl['bottleneck']};"
                f"frac={rl['roofline_fraction']:.4f};"
                f"mem_gb={rl['mem_per_chip_gb']:.2f}"))
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path}: malformed cell {r!r:.200}") from e
    return rows


def rows(device: str = "cuda", root=None, results=None) -> list:
    """Every row, in the printer's order."""
    out = []
    for fn in figures.FIGURES:
        out.extend(fn(root=root, device=device))
    out.extend(kernel_bench.kernel_benchmarks(device=device))
    return out + dryrun_rows(results or os.path.join(REPO, "results"))


def dryrun_rows(results: str) -> list:
    """The roofline rows of the port's dry-run files in ``results``."""
    out = []
    for name in DRYRUN_FILES:
        path = os.path.join(results, name)
        if os.path.exists(path):
            out.extend(roofline_rows(path))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the sessions run (default: the card)")
    ap.add_argument("--root", default=None,
                    help="sweep store root (default: the port's own)")
    ap.add_argument("--results", default=None,
                    help="directory of the dry-run files "
                         "(default: the repository's results/)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass --device cpu to run on the host")
    table = rows(args.device, default_root(args.root), args.results)
    print("name,us_per_call,derived")
    for name, us, derived in table:
        print(f"{name},{us:.2f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
