"""The control of the division cells: the reference's float32 division
put in the program's place, judged by the checks a run makes.  It has to
come out not correct.

    python port_bench/control/run_control_div.py --workload <cell> \
        --seeds <n> [<n> ...] [--device cuda]

``run_control.py`` picks its answers by the driver's name (``arith``, or
else the serve path); a cell of the ``arith_div`` driver draws its
operands as a run does (divisors ``u32 >> k``) with the same answers
helper here.  Prints one JSON line a seed: the checks, each number
beside its limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def control_checks(workload: str, seed: int, device: str = "cpu",
                   overrides=None) -> dict:
    from port_bench.control.run_control import arith_answers
    from port_bench.harness import spec
    from port_bench.harness.runner import merged

    cell = spec.load_cell(workload)
    overrides = overrides or {}
    cell.config = merged(cell.config, overrides.get("config"))
    cell.traffic = merged(cell.traffic, overrides.get("traffic"))
    if cell.config["driver"] != "arith_div":
        raise ValueError(f"{workload}: not a division cell; use "
                         f"run_control.py")
    answers = arith_answers(cell, seed, device)
    checks = spec.driver(cell.config).check(answers, cell.config,
                                            cell.traffic, seed)
    return {c.name: {"value": c.value, "limit": c.limit, "ok": c.ok}
            for c in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for seed in args.seeds:
        checks = control_checks(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(c["ok"] for c in checks.values()),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
