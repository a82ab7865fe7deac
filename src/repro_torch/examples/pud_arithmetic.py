"""The §8.1 case study as a runnable example: the seven majority-based
microbenchmarks across MAJX tiers, with the calibrated latency model,
in the structure of the paper's Fig. 16.

The counterpart of the reference's ``examples/pud_arithmetic.py``; the
latency model is :func:`repro_torch.paper.figures._microbench_time_ns`.

Usage:  python -m repro_torch.examples.pud_arithmetic [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.backends import ExecutionContext
from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.paper.figures import _microbench_time_ns
from repro_torch.session import DramSession

#: One-string backend choice ("oracle" compiles and computes the
#: programs; "cuda" or "sim" run the same gates elsewhere).
BACKEND = "oracle"


def main(argv=None):
    ap = argparse.ArgumentParser(description="§8.1 microbenchmarks")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs (default: the card)")
    device = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 32, dtype=np.uint32)
    b = np.maximum(rng.integers(0, 2**32, 32, dtype=np.uint32), 1)
    backend = DramSession(BACKEND, ExecutionContext(device=device))

    print("op   tier  DRAM-ops   exact   modeled-us")
    for op in cal.MICROBENCHMARKS:
        for tier in (3, 5, 7):
            out, prog = backend.elementwise(op, a, b, tier=tier,
                                            n_act=32 if tier > 3 else 4)
            ref = {"and": a & b, "or": a | b, "xor": a ^ b,
                   "add": (a + b).astype(np.uint32),
                   "sub": (a - b).astype(np.uint32),
                   "mul": (a * b).astype(np.uint32),
                   "div": a // b}[op]
            exact = bool((bp.to_u32(out) == ref).all())
            t_us = _microbench_time_ns(op, "H", tier, device) / 1e3
            print(f"{op:5s} MAJ{tier}  {len(prog.ops):7d}   {exact}   "
                  f"{t_us:10.1f}")
    print("\nFig.16-style speedups over the MAJ3@4-row baseline:")
    for mfr in ("M", "H"):
        tiers = (5, 7) if mfr == "M" else (5, 7, 9)
        for t in tiers:
            sp = [(_microbench_time_ns(op, mfr, 3, device)
                   / _microbench_time_ns(op, mfr, t, device))
                  for op in cal.MICROBENCHMARKS]
            print(f"  Mfr {mfr} MAJ{t}: avg {np.mean(sp):.2f}x "
                  f"(paper: M +121.6%/H +46.5% avg for the new MAJX ops)")


if __name__ == "__main__":
    main()
