"""Run every (arch x shape) dry-run cell, one process a cell, and merge
the rows into one JSON file.

The counterpart of the reference's ``results/run_all_cells.py``, over
``python -m repro_torch.launch.dryrun``.  Before any cell it runs a
PUD-backend preflight: the tiny MAJX and Multi-RowCopy sweeps of
:func:`repro_torch.sweep.presets.preflight_specs` on the configured
backend (``--pud-backend``, else ``$PUD_BACKEND``, else ``cuda``) and
device, in a fresh store, whose records must all succeed against the
oracle, so a bad backend fails in seconds rather than after hours of
cells.  Train cells take the reference's microbatches by arch (:data:`MB`);
a cell already ``ok`` or ``skipped`` in the output file is not run
again, so an interrupted run resumes.

Usage:
  python -m repro_torch.paper.run_all_cells results/torch_dryrun_single.json
      [--pud-backend NAME] [--device cpu] [--multipod] [--skip-cost]
      [--serve-rules]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b", "chatglm3-6b", "gemma-7b",
         "deepseek-coder-33b", "glm4-9b", "zamba2-1.2b", "musicgen-medium",
         "xlstm-125m", "phi-3-vision-4.2b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: Grad-accumulation microbatches of a train cell, by arch (default 4).
MB = {"mixtral-8x22b": 8, "qwen3-moe-235b-a22b": 8}
KIND = {"train_4k": "train", "prefill_32k": "prefill",
        "decode_32k": "decode", "long_500k": "decode"}
#: Seconds a cell's process may take.
CELL_TIMEOUT = 2400


def pud_preflight(backend: str, device: str) -> None:
    """The preflight sweeps on ``backend``: every record must succeed."""
    from repro_torch.sweep import presets, run_sweep

    # a fresh store each time: a cached preflight checks nothing
    root = tempfile.mkdtemp(prefix="pud_preflight_")
    try:
        for spec in presets.preflight_specs(backend):
            result = run_sweep(spec, root, device=device)
            bad = [r for r in result.records if r["success"] < 1.0]
            if bad:
                raise RuntimeError(
                    f"backend '{backend}' lost parity vs oracle on "
                    f"{spec.op} points: "
                    f"{[(r['x'], r['n_act'], r['success']) for r in bad]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[preflight] backend '{backend}' sweep parity vs oracle OK",
          flush=True)


def load_results(path: str) -> list:
    """The rows already in ``path`` (none if it does not exist)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def cell_command(arch: str, shape: str, out: str, args) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape,
           "--microbatches", str(MB.get(arch, 4)), "--out", out]
    return cmd + (["--multipod"] * args.multipod
                  + ["--skip-cost"] * args.skip_cost
                  + ["--serve-rules"] * args.serve_rules)


def pending(results: list, only_kinds: str = "") -> list:
    """The (arch, shape) cells still to run: not ``ok`` or ``skipped`` in
    ``results``, and of a kind in ``only_kinds`` where it is given."""
    done = {(r["arch"], r["shape"]) for r in results
            if r.get("status") in ("ok", "skipped")}
    return [(a, s) for a in ARCHS for s in SHAPES
            if (a, s) not in done and (not only_kinds
                                       or KIND[s] in only_kinds)]


def run_cell(arch: str, shape: str, args) -> dict:
    """One cell in its own process; its row, or an ``error`` row."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        p = subprocess.run(cell_command(arch, shape, out, args), env=env,
                           cwd=REPO, capture_output=True, text=True,
                           timeout=CELL_TIMEOUT)
        try:
            with open(out) as f:
                return json.load(f)[0]
        except (OSError, ValueError, IndexError):
            return {"arch": arch, "shape": shape, "status": "error",
                    "error": f"rc={p.returncode}: {p.stderr[-500:]}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the merged JSON file (read to resume)")
    ap.add_argument("--pud-backend",
                    default=os.environ.get("PUD_BACKEND", "cuda"))
    ap.add_argument("--device", default="cuda",
                    help="where the preflight runs (default: the card)")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--serve-rules", action="store_true")
    args = ap.parse_args(argv)

    pud_preflight(args.pud_backend, args.device)
    results = load_results(args.out)
    for arch, shape in pending(results, os.environ.get("ONLY_KINDS", "")):
        t0 = time.time()
        r = run_cell(arch, shape, args)
        results = [x for x in results
                   if (x["arch"], x["shape"]) != (arch, shape)] + [r]
        extra = ""
        if r["status"] == "ok":
            extra = (f"mem={r['memory']['total_gb']:.1f}GB "
                     f"bound={r['roofline']['bottleneck']}")
        print(f"[{arch} {shape}] {r['status']} {extra} "
              f"({time.time() - t0:.0f}s)", flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    print(f"TOTAL: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed")
    return 0 if n_ok + n_skip == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
