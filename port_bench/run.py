"""Run one cell of BENCHMARK.json once on the card.

    python port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Prints a set-up line, then as its last line of standard output one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, which also end standard error).  Exits
non-zero, printing no result, without enough cards, when the program is
not in the checkout, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The checkout's program and this package on the import path, and
    every cache inside the checkout at a fixed place."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import torch

    from port_bench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device: the benchmark runs only on the "
              "card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
