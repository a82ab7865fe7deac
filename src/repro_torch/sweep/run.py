"""CLI: run characterization sweeps.

.. code-block:: bash

    # <=16-point executable smoke grid on sim + cuda (on the card):
    python -m repro_torch.sweep.run --smoke

    # the same on the CPU (every kernel wrapper takes its plain version):
    python -m repro_torch.sweep.run --smoke --device cpu

    # one paper figure's grid (see --list-figures):
    python -m repro_torch.sweep.run --figure fig6

    # a custom campaign from a JSON spec, worker 2 of 4:
    python -m repro_torch.sweep.run --spec campaign.json --shards 4 \
        --shard-index 2

    # adaptive boundary search instead of the dense grid:
    python -m repro_torch.sweep.run --adaptive      # the adaptive smoke
    python -m repro_torch.sweep.run --adaptive --figure fig6

    # fault-tolerant multi-worker run (elastic membership, straggler
    # re-dispatch) inside one process:
    python -m repro_torch.sweep.run --smoke --workers 4

Record stores land under ``--root`` (default: ``$REPRO_SWEEP_ROOT`` if
set, else the repo-relative ``results/sweeps``), one directory per spec
hash.
Re-running with an unchanged spec executes only missing chunks;
``--expect-cached`` turns "nothing left to execute" into an exit-code
assertion, which is how CI verifies resume semantics for both grid and
adaptive campaigns.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.sweep import aggregate, presets
from repro_torch.sweep.adaptive import AdaptiveSpec, run_adaptive
from repro_torch.sweep.runner import run_sweep, run_sweep_ft
from repro_torch.sweep.spec import SweepSpec, load_spec


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.run",
        description="Run a characterization sweep.")
    what = p.add_mutually_exclusive_group()
    what.add_argument("--smoke", action="store_true",
                      help="<=16-point executable parity grid")
    what.add_argument("--figure", metavar="NAME",
                      help="a paper-figure preset (--list-figures)")
    what.add_argument("--spec", metavar="FILE",
                      help="JSON SweepSpec file")
    p.add_argument("--list-figures", action="store_true",
                   help="list figure presets and exit")
    p.add_argument("--adaptive", action="store_true",
                   help="boundary-search the grid instead of executing it "
                        "densely (with no --smoke/--figure/--spec: the "
                        "adaptive smoke ladder)")
    p.add_argument("--root", default=None,
                   help="record-store root (default: $REPRO_SWEEP_ROOT, "
                        "else <repo>/results/sweeps)")
    p.add_argument("--backends", default=None,
                   help="comma-separated backend override, e.g. sim,cuda")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="where sessions run (default: the card)")
    p.add_argument("--shards", type=int, default=1,
                   help="total cooperating worker *processes* (disjoint "
                        "deterministic partition; dense mode only)")
    p.add_argument("--shard-index", type=int, default=0,
                   help="this worker's index in [0, --shards)")
    p.add_argument("--workers", type=int, default=1,
                   help="in-process fault-tolerant worker threads "
                        "(elastic membership + straggler re-dispatch; "
                        "dense mode only)")
    p.add_argument("--max-chunks", type=int, default=None,
                   help="stop after N chunks (partial run; resumable)")
    p.add_argument("--expect-cached", action="store_true",
                   help="fail if any chunk had to execute (CI resume check)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-chunk progress lines")
    return p


def _resolve_spec(args) -> SweepSpec:
    if args.spec:
        spec = load_spec(args.spec)
    elif args.figure:
        try:
            spec = presets.FIGURE_SPECS[args.figure]()
        except KeyError:
            sys.exit(f"unknown figure {args.figure!r}; "
                     f"known: {sorted(presets.FIGURE_SPECS)}")
    elif args.adaptive:  # bare --adaptive runs the adaptive smoke ladder
        return presets.adaptive_smoke_spec().base
    else:  # --smoke is also the default action
        spec = presets.smoke_spec()
    if args.backends:
        try:
            spec = spec.replace(backends=tuple(args.backends.split(",")))
        except ValueError as e:
            sys.exit(str(e))
    return spec


def _print_aggregates(records: list[dict]) -> None:
    if not records:
        return
    head = aggregate.headline(records)
    for k, v in head.items():
        print(f"  {k} = {v:+.4f}")
    by_op = aggregate.group_mean(records, ("op", "backend"))
    for (op, be), s in by_op.items():
        print(f"  mean success [{op}/{be}] = {s:.4f}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_figures:
        for name, make in presets.FIGURE_SPECS.items():
            print(f"{name:8s} {make.__doc__.splitlines()[0]}")
        return 0
    if args.adaptive and (args.shards != 1 or args.workers != 1):
        sys.exit("--adaptive is a sequential search; it cannot be combined "
                 "with --shards/--workers")

    spec = _resolve_spec(args)

    if args.adaptive:
        if args.smoke or args.figure or args.spec:
            aspec = AdaptiveSpec(base=spec)
        else:
            aspec = presets.adaptive_smoke_spec()
        result = run_adaptive(aspec, args.root, max_chunks=args.max_chunks,
                              progress=not args.quiet, device=args.device)
        print(result.summary())
        for c in result.crossings:
            print(f"  {c.describe()}")
        _print_aggregates(result.records)
        if args.expect_cached and result.executed_chunks:
            print(f"--expect-cached: {result.executed_chunks} chunks "
                  f"executed (wanted 0)", file=sys.stderr)
            return 1
        return 0

    if args.workers > 1:
        result = run_sweep_ft(spec, args.root, n_workers=args.workers,
                              progress=not args.quiet, device=args.device)
    else:
        result = run_sweep(
            spec, args.root, num_shards=args.shards,
            shard_index=args.shard_index, max_chunks=args.max_chunks,
            progress=not args.quiet, device=args.device)
    print(result.summary())
    _print_aggregates(result.records)

    if args.expect_cached and result.executed_chunks:
        print(f"--expect-cached: {result.executed_chunks} chunks executed "
              f"(wanted 0)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
