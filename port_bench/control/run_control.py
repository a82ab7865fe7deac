"""The control of a cell's comparison: the plain reference put in the
program's place, one step below what the configuration guarantees, judged
by the same checks a run makes.  It has to come out not correct.

    python port_bench/control/run_control.py --workload <cell> \
        --seeds <n> [<n> ...] [--device cuda]

* ``simdram-arith``: the reference's arithmetic in float32 (``control``)
  over the operands a run draws, as many answers of each op as a run
  compares;
* ``pud-integrity-service``: heals answered by replica 0 unvoted
  (``control_heal``) over the pool a run makes, every pool entry once.

Prints one JSON line a seed: the checks, each number beside its limit.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def arith_answers(cell, seed: int, device: str) -> list:
    from port_bench.harness.spec import driver, reference
    from port_bench.harness.traffic import mix_sequence

    drv, ref = driver(cell.config), reference(cell.config)
    st = drv.State(cell.config, cell.traffic, seed, device)
    ops = mix_sequence(cell.traffic["mix"], cell.traffic["deck_copies"],
                       seed)
    want = {op: int(cell.traffic["sample_per_op"])
            for op in cell.config["ops"]}
    out, index = [], 0
    while any(want.values()):
        op = next(ops)
        if want[op]:
            want[op] -= 1
            a, b = (drv._u32(t) for t in st.operands(index))
            out.append((index, op, a, b, ref.control(op, a, b)))
        index += 1
    return out


def serve_answers(cell, seed: int, device: str) -> dict:
    from port_bench.harness.spec import driver, reference

    drv, ref = driver(cell.config), reference(cell.config)
    words = int(cell.config["words"])
    pool = drv.make_pool(cell.traffic, words, seed, device)
    heal = [(j, *ref.control_heal(r)) for j, r in enumerate(pool["heal"])]
    erase = ref.erase(int(cell.traffic["erase_rows"]), words,
                      int(cell.traffic["pattern"]))
    return {"pool": pool, "words": words,
            "counts": {"heal": [(j, fixed) for j, _, fixed in heal],
                       "verify": [(j, ref.verify(*p))
                                  for j, p in enumerate(pool["verify"])],
                       "erase": 1},
            "tiles": {"heal": [(j, tile) for j, tile, _ in heal],
                      "erase": [(0, erase)]}}


def control_checks(workload: str, seed: int, device: str = "cpu",
                   overrides=None) -> dict:
    from port_bench.harness import spec
    from port_bench.harness.runner import merged

    cell = spec.load_cell(workload, spec.with_shelved(spec.load_spec()))
    overrides = overrides or {}
    cell.config = merged(cell.config, overrides.get("config"))
    cell.traffic = merged(cell.traffic, overrides.get("traffic"))
    make = arith_answers if cell.config["driver"] == "arith" \
        else serve_answers
    answers = make(cell, seed, device)
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
