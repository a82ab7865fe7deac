"""Write the port's experiment tables from its dry-run files and sweep
stores.

The counterpart of the reference's ``results/make_tables.py``.  It reads
``torch_dryrun_{single,multi,serve}.json`` (as
:mod:`repro_torch.paper.run_all_cells` writes them) from a results
directory and every campaign stored under the port's sweep root, and
writes four tables (sweeps, dry run, roofline, serve rules) to the file
it is given; the reference writes into ``EXPERIMENTS.md``, this never
does.  The sweep table is reduced through
:mod:`repro_torch.sweep.aggregate`.

Usage:
  python -m repro_torch.paper.make_tables OUT.md [--results DIR]
      [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.paper.run import DRYRUN_FILES, REPO

SCAFFOLD = """# Experiments of the PyTorch/CUDA port

## Characterization sweeps

{sweeps}

## Dry run

{dryrun}

## Roofline

{roofline}

## Serve rules

{serve}
"""

#: What would move each bound (the reference's hints, for the H100).
HINTS = {
    "collective": "less wire traffic: bf16 collectives, fewer regathers",
    "memory": "smaller dtypes / fewer remat passes / fused elementwise",
    "compute": "higher tensor-core utilization (already near bound)",
}


def load(results: str, name: str) -> list:
    path = os.path.join(results, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def sweep_table(root: str) -> str:
    """One row a stored campaign: grid size and headline aggregates."""
    from repro_torch.sweep import aggregate, discover

    lines = ["| sweep | op | backends | points | mean success | headline |",
             "|---|---|---|---|---|---|"]
    n = 0
    for spec, store in discover(root):
        recs = store.records()
        if not recs:
            continue
        n += 1
        head = "; ".join(f"{k}={v:+.4f}"
                         for k, v in aggregate.headline(recs).items())
        lines.append(
            f"| {spec.name} | {spec.op} | {','.join(spec.backends)} | "
            f"{len(recs)}/{spec.n_points()} | "
            f"{aggregate.mean_success(recs):.4f} | {head or '—'} |")
    return "\n".join(lines) if n else f"(no sweep records under {root})"


def fmt(x, nd=3) -> str:
    if x == 0:
        return "0"
    return f"{x:.2e}" if (abs(x) < 1e-3 or abs(x) >= 1e4) else f"{x:.{nd}f}"


def tables(single: list, multi: list, serve: list) -> dict:
    """The dry-run, roofline and serve-rules tables from the rows."""
    by_cell = {(r["arch"], r["shape"]): r for r in single}
    multi_by = {(r["arch"], r["shape"]): r for r in multi}
    serve_by = {(r["arch"], r["shape"]): r for r in serve
                if r.get("status") == "ok"}
    order = sorted(by_cell)

    lines = ["| arch | shape | 16x16 mem/chip | 2x16x16 mem/chip | status |",
             "|---|---|---|---|---|"]
    for cell in order:
        r1, r2 = by_cell[cell], multi_by.get(cell, {})
        if r1.get("status") == "skipped":
            lines.append(f"| {cell[0]} | {cell[1]} | — | — | skipped: "
                         f"{r1['reason'][:60]} |")
            continue
        m1 = (f"{r1['memory']['total_gb']:.1f} GB"
              if r1.get("status") == "ok" else "ERR")
        m2 = (f"{r2['memory']['total_gb']:.1f} GB"
              if r2.get("status") == "ok" else r2.get("status", "—"))
        lines.append(f"| {cell[0]} | {cell[1]} | {m1} | {m2} | "
                     f"{'counted' if r1.get('status') == 'ok' else 'error'} |")
    dryrun = "\n".join(lines)

    lines = ["| arch | shape | t_compute | t_memory | t_collective | bound |"
             " frac | MODEL_FLOPS | MODEL/counted | moved-by |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for cell in order:
        r = by_cell[cell]
        if r.get("status") != "ok":
            continue
        rl = r["roofline"]
        lines.append(
            f"| {cell[0]} | {cell[1]} | {fmt(rl['t_compute_s'])} | "
            f"{fmt(rl['t_memory_s'])} | {fmt(rl['t_collective_s'])} | "
            f"{rl['bottleneck']} | {rl['roofline_fraction']:.3f} | "
            f"{fmt(rl['model_flops'])} | {rl['hlo_efficiency']:.2f} | "
            f"{HINTS[rl['bottleneck']]} |")
    roofline = "\n".join(lines)

    lines = ["| arch | shape | baseline t_coll | SERVE_RULES t_coll | gain |",
             "|---|---|---|---|---|"]
    for cell in order:
        r0 = by_cell[cell]
        if cell not in serve_by or r0.get("status") != "ok":
            continue
        t0 = r0["roofline"]["t_collective_s"]
        t1 = serve_by[cell]["roofline"]["t_collective_s"]
        if t1 > 0:
            lines.append(f"| {cell[0]} | {cell[1]} | {fmt(t0)} s | "
                         f"{fmt(t1)} s | {t0 / t1:.1f}x |")
    return {"dryrun": dryrun, "roofline": roofline,
            "serve": "\n".join(lines)}


def main(argv=None) -> int:
    from repro_torch.sweep import default_root

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the tables' file (overwritten)")
    ap.add_argument("--results", default=os.path.join(REPO, "results"),
                    help="directory of the port's dry-run files")
    ap.add_argument("--root", default=None, help="sweep store root")
    args = ap.parse_args(argv)
    single, multi, serve = (load(args.results, n) for n in DRYRUN_FILES)
    text = SCAFFOLD.format(sweeps=sweep_table(default_root(args.root)),
                           **tables(single, multi, serve))
    with open(args.out, "w") as f:
        f.write(text)
    print(f"tables written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
