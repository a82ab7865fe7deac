"""``python -m repro_torch.analyze`` — lint and certify the real programs.

Subjects (combine freely; ``--all`` is every subject plus the negative
mutation gate and the certificate-cache check):

* ``--golden``  — every ``tests/golden/*.json`` fixture program,
  certified against a freshly built schedule AND megakernel lowering;
  when the fixture carries a frozen ``certificate`` section, the
  recomputed digest must match it byte-for-byte.
* ``--serve``   — the heal and erase tick programs the serve batcher
  actually builds (captured from a real
  :class:`~repro_torch.serve.batcher.Batcher` tick on the oracle
  backend, on ``--device``: the card unless told otherwise).
* ``--sweep``   — the fused MAJX chunk programs of the smoke sweep
  spec, as planned by :func:`repro_torch.sweep.planner.plan`.
* ``--mutate``  — the negative gate: every applicable seeded mutation
  (:mod:`repro_torch.analyze.mutate`) of every golden lowering must be
  *rejected*; an accepted mutation is a hole in the analyzer and fails
  the run.
* ``--cache-check`` — certify one golden program twice through a fresh
  :class:`~repro_torch.session.cache.CompileCache` and assert the second
  lookup is a pure cache hit (zero re-analysis).

Exit status is nonzero on any error finding, digest mismatch, accepted
mutation, or missed cache hit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analyze.cert import CertificationError, certify
from repro_torch.analyze.mutate import MUTATIONS
from repro_torch.compile.megakernel import lower_schedule
from repro_torch.compile.schedule import build_schedule
from repro_torch.pud.isa import Program


def _golden_dir(override: str = "") -> str:
    if override:
        return override
    return os.path.join(os.getcwd(), "tests", "golden")


def _load_golden(path: str) -> tuple[str, Program, dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["name"], Program.from_json(json.dumps(doc["ops"])), doc


def _certify_one(name: str, prog: Program, *, verbose: bool,
                 frozen: dict | None = None) -> bool:
    """Certify prog (schedule + lowering); print one line; True on OK."""
    sched = build_schedule(prog)
    low = lower_schedule(sched)
    try:
        cert = certify(prog, sched=sched, lowering=low, where=name)
    except CertificationError as e:
        print(f"FAIL {name}")
        print("  " + "\n  ".join(str(f) for f in e.report.errors[:10]))
        return False
    warns = sum(w for _, _, w in cert.summary)
    print(f"OK   {name}: {cert.n_ops} ops / {cert.n_levels} levels, "
          f"{warns} warning(s), cert {cert.digest[:12]}")
    if verbose:
        for pname, errs, ws in cert.summary:
            print(f"       {pname}: {errs} error(s), {ws} warning(s)")
    if frozen is not None and frozen.get("digest") != cert.digest:
        print(f"FAIL {name}: frozen certificate digest "
              f"{frozen.get('digest', '?')[:12]} != recomputed "
              f"{cert.digest[:12]} — regenerate tests/golden or fix "
              f"the analyzer drift")
        return False
    return True


def _golden_programs(golden_dir: str) -> list[tuple[str, Program, dict]]:
    paths = sorted(
        os.path.join(golden_dir, p) for p in os.listdir(golden_dir)
        if p.endswith(".json"))
    return [_load_golden(p) for p in paths]


def lint_golden(golden_dir: str, verbose: bool) -> bool:
    ok = True
    for name, prog, doc in _golden_programs(golden_dir):
        ok &= _certify_one(f"golden/{name}", prog, verbose=verbose,
                           frozen=doc.get("certificate"))
    return ok


def lint_serve(verbose: bool, device: str = "cuda") -> bool:
    """Certify the tick programs a real Batcher builds (oracle backend
    on ``device``)."""
    import numpy as np

    from repro_torch.backends import ExecutionContext
    from repro_torch.serve.batcher import Batcher
    from repro_torch.serve.queue import EraseRequest, HealRequest
    from repro_torch.session import DramSession

    session = DramSession("oracle", ExecutionContext(ideal=True,
                                                     device=device),
                          name="analyze/serve")
    captured: list[tuple[str, Program]] = []
    inner = session.run_fused

    def run_fused(prog, state, **kw):
        captured.append((prog.ops[0].tag or "tick", prog))
        return inner(prog, state, **kw)

    session.run_fused = run_fused  # capture the real construction path
    rng = np.random.default_rng(7)
    heal = [HealRequest(tenant=f"t{i}", replicas=rng.integers(
        0, 2**32, (3, 2, 4), dtype=np.uint32)) for i in range(3)]
    erase = [EraseRequest(tenant=f"t{i}", rows=5, words=4, pattern=0,
                          fanout=4) for i in range(2)]
    batcher = Batcher()
    for plan in batcher.plan([*heal, *erase]):
        batcher.execute(plan, session)

    ok = bool(captured)
    if not captured:
        print("FAIL serve: no tick programs captured")
    for i, (tag, prog) in enumerate(captured):
        ok &= _certify_one(f"serve/tick{i}[{tag}]", prog, verbose=verbose)
    return ok


def lint_sweep(verbose: bool) -> bool:
    """Certify the fused chunk programs of the smoke sweep spec."""
    from repro_torch.session.cache import program_key
    from repro_torch.sweep.planner import fused_majx_program, plan
    from repro_torch.sweep.presets import smoke_spec

    spec = smoke_spec()
    ok = True
    seen: set[str] = set()
    for chunk in plan(spec):
        prog, _ = fused_majx_program(chunk.points, spec.rows)
        key = program_key(prog)
        if key in seen:
            continue  # same chunk shape across backends — one lint
        seen.add(key)
        ok &= _certify_one(f"sweep/{spec.name}/{chunk.key}", prog,
                           verbose=verbose)
    return ok


def mutation_gate(golden_dir: str, verbose: bool) -> bool:
    """Every applicable seeded mutation must be rejected on every fixture."""
    ok = True
    applied: dict[str, int] = {m: 0 for m in MUTATIONS}
    rejected: dict[str, int] = {m: 0 for m in MUTATIONS}
    for name, prog, _ in _golden_programs(golden_dir):
        sched = build_schedule(prog)
        low = lower_schedule(sched)
        for mname, fn in MUTATIONS.items():
            bad = fn(low)
            if bad is None:
                continue  # no site on this fixture (e.g. no NOT ops)
            applied[mname] += 1
            try:
                certify(prog, sched=sched, lowering=bad,
                        where=f"{name}+{mname}")
                print(f"FAIL mutate/{name}+{mname}: corrupted lowering "
                      f"was certified — analyzer hole")
                ok = False
            except CertificationError as e:
                rejected[mname] += 1
                if verbose:
                    codes = sorted({f.code for f in e.report.errors})
                    print(f"     {name}+{mname}: rejected via {codes}")
    for mname in MUTATIONS:
        if applied[mname] == 0:
            print(f"FAIL mutate/{mname}: applicable to zero fixtures — "
                  f"the negative gate never exercised it")
            ok = False
        else:
            print(f"OK   mutate/{mname}: rejected "
                  f"{rejected[mname]}/{applied[mname]} seeded corruption(s)")
    return ok


def cache_check(golden_dir: str) -> bool:
    """Repeat certification of a cached program must be zero re-analysis."""
    from repro_torch.session.cache import CompileCache

    name, prog, _ = _golden_programs(golden_dir)[0]
    cache = CompileCache()
    sched = cache.schedule_for(prog)
    low = cache.lowering_for(prog, sched=sched)
    first = cache.certificate_for(prog, sched=sched, lowering=low)
    again = cache.certificate_for(prog, sched=sched, lowering=low)
    stats = cache.certificate_stats
    if stats.hits != 1 or stats.misses != 1 or first is not again:
        print(f"FAIL cache: expected 1 miss + 1 hit, got "
              f"{stats.misses} miss(es) + {stats.hits} hit(s)")
        return False
    print(f"OK   cache: {name} re-certification was a pure hit "
          f"(cert {first.digest[:12]}, 1 miss + 1 hit)")
    return True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Certify the repo's PUD programs and compiled "
                    "artifacts (races / liveness / equivalence).")
    ap.add_argument("--golden", action="store_true",
                    help="lint every tests/golden fixture")
    ap.add_argument("--serve", action="store_true",
                    help="lint the serve batcher's tick programs")
    ap.add_argument("--sweep", action="store_true",
                    help="lint the smoke sweep's chunk programs")
    ap.add_argument("--mutate", action="store_true",
                    help="negative gate: seeded mutations must be rejected")
    ap.add_argument("--cache-check", action="store_true",
                    help="assert repeat certification is a pure cache hit")
    ap.add_argument("--all", action="store_true",
                    help="every subject plus the mutation and cache gates")
    ap.add_argument("--golden-dir", default="",
                    help="override the golden fixture directory")
    ap.add_argument("--device", default="cuda",
                    help="where --serve runs its tick (default: the card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if not any((args.golden, args.serve, args.sweep, args.mutate,
                args.cache_check, args.all)):
        args.all = True

    golden_dir = _golden_dir(args.golden_dir)
    ok = True
    if args.golden or args.all:
        ok &= lint_golden(golden_dir, args.verbose)
    if args.serve or args.all:
        ok &= lint_serve(args.verbose, args.device)
    if args.sweep or args.all:
        ok &= lint_sweep(args.verbose)
    if args.mutate or args.all:
        ok &= mutation_gate(golden_dir, args.verbose)
    if args.cache_check or args.all:
        ok &= cache_check(golden_dir)
    print("analyze: all gates passed" if ok
          else "analyze: FAILURES (see above)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
