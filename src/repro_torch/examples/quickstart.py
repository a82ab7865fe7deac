"""Quickstart: the paper's PUD operations through `repro_torch.session`.

The counterpart of the reference's ``examples/quickstart.py``.  One
typed :class:`DramSession` per executor: the session owns the backend
and its ``ExecutionContext``, hands out validated row handles, lowers
programs through ``repro_torch.compile`` and caches fused schedules by
program content:

  * ``oracle``  pure bitwise reference (ground truth),
  * ``sim``     behavioural DRAM model with the calibrated error surfaces,
  * ``cuda``    the hand-written kernels on the card (their plain
                versions on the CPU).

It shows:
  1. simultaneous many-row activation success (calibrated model),
  2. MAJ5 with input replication on every backend: identical results
     when ideal, paper-calibrated success rates when not (Obs 10),
  3. Multi-RowCopy 1 -> 31 parity across backends,
  4. a typed session program (row handles, build-time validation) run by
     all three backends, with its latency and energy under the
     calibrated model, and what a bad row address looks like,
  5. majority-based 32-bit addition per session, the compile cache
     turning a repeated program into a schedule-cache hit.

Usage:  python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.backends import ExecutionContext, available_backends
from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.core.errormodel import ErrorModel
from repro_torch.session import DramSession, SessionError

BACKENDS = ("oracle", "sim", "cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description="PUD operations per backend")
    ap.add_argument("--device", default="cuda",
                    help="where the sessions run (default: the card)")
    device = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    ideal = ExecutionContext(ideal=True, device=device)
    sessions = {n: DramSession(n, ideal) for n in BACKENDS}

    # 1) simultaneous many-row activation -------------------------------
    em = ErrorModel("H")
    print("== SiMRA: N-row activation success (calibrated to Obs 1) ==")
    for n in cal.N_ACT_LEVELS:
        print(f"  {n:2d}-row activation: {em.simra_success(n)*100:.2f}%")

    # 2) MAJ5 with input replication across backends ---------------------
    planes = bp.from_u32(rng.integers(0, 2**32, (5, 32), dtype=np.uint32),
                         device)
    want = sessions["oracle"].majx(planes)
    print(f"\n== MAJ5 on every backend (registry: {available_backends()}) ==")
    for name, sess in sessions.items():
        got = sess.majx(planes, n_act=32)
        print(f"  {name:7s} (ideal): bit-exact={bool((got == want).all())}")
    for n_act in (8, 32):
        sim = DramSession("sim", ExecutionContext(seed=1, device=device))
        acc = sim.success_rate(sim.majx(planes, n_act=n_act), want)
        print(f"  sim MAJ5 @ {n_act:2d}-row activation: measured "
              f"{acc*100:.1f}% (model {em.majx_success(5, n_act)*100:.1f}%, "
              f"Obs 10 replication gain)")

    # 3) Multi-RowCopy ----------------------------------------------------
    src = bp.from_u32(rng.integers(0, 2**32, (32,), dtype=np.uint32), device)
    copies = {n: s.rowcopy(src, 31) for n, s in sessions.items()}
    ok = all(bool((c == src).all()) for c in copies.values())
    print(f"\n== Multi-RowCopy 1 -> 31 on all backends, bit-exact={ok} ==")

    # 4) one typed session program, three executors -----------------------
    b = sessions["oracle"].program(rows=12, name="quickstart-demo")
    ops = b.input(rng.integers(0, 2**32, (3, 8), dtype=np.uint32))
    vote = b.maj(ops[0], ops[1], ops[2], n_act=4, tag="demo/vote")
    flip = b.not_(vote, tag="demo/flip")
    b.mrc(flip, 7, tag="demo/fanout")
    prog, state = b.build(), b.initial_state()
    finals = [bp.to_u32(s.run_fused(prog, state)) for s in sessions.values()]
    agree = all((f == finals[0]).all() for f in finals)
    print(f"\n== typed Program({len(prog.ops)} ops) via "
          f"{'/'.join(BACKENDS)}: states agree={agree}; "
          f"{prog.latency_ns(em):.0f} ns / {prog.energy_nj(em):.0f} nJ "
          f"modeled ==")
    try:  # the allocator catches bad programs before any kernel runs
        b.mrc(flip, b.alloc_rows(7))
    except SessionError as e:
        print(f"  build-time validation: {e}")

    # 5) majority-based arithmetic (§8.1), compile-cached per session ----
    a = rng.integers(0, 2**32, 64, dtype=np.uint32)
    c = rng.integers(0, 2**32, 64, dtype=np.uint32)
    print()
    for name, sess in sessions.items():
        out, prog = sess.elementwise("add", a, c, tier=5, n_act=32)
        if sess.capabilities().native_batch:
            # repeat the fused path: the schedule comes from the cache
            out, prog = sess.elementwise("add", a, c, tier=5, n_act=32)
        if not (bp.to_u32(out) == (a + c).astype(np.uint32)).all():
            raise RuntimeError(f"32-bit ADD via {name} is not exact")
        lat_us = prog.latency_ns(em, pipelined=True, best_group=True) / 1e3
        stats = sess.cache.stats
        print(f"  32-bit ADD via {name:7s}: {len(prog.ops)} DRAM ops, "
              f"{lat_us:.1f} us modeled, bit-exact vs numpy; compile "
              f"cache {stats.hits} hits / {stats.misses} misses")

    print("\nquickstart OK")


if __name__ == "__main__":
    main()
