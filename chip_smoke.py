#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is program execution: an addressed ``Program`` is
scheduled into dependency levels, lowered to megakernel tables, and run
by the ``cuda`` backend per op, level-fused and as one megakernel launch.
Phases, one JSON line each:

1. build — compile the CUDA kernels of ``src/repro_torch/csrc`` with
   nvcc (all sources at once) and print the card's name and power limit;
2. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, bit-exact, with median times;
3. path — the ``add32``, ``maj9_tree`` and ``mrc_fanout31`` golden
   Programs at 2**18 words a row (one DDR4 bank: 128 subarrays of one
   8 KiB rank row), plus the full ``erase_mrc31`` Multi-RowCopy wipe,
   per-op == fused == megakernel == the ``oracle`` backend, and the
   seven golden Programs at their own width against their frozen
   expected rows.  Every kernel's launch count is zeroed before this
   phase and must add up to the backend's dispatches after it;
4. the kernels line, then ``{"ok": true, ...}`` as the last line.

Any failed check raises, so the script exits non-zero and prints no
result.  It needs ``torch.cuda.is_available()`` and the repository's
``src/`` and ``tests/golden/`` beside it.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORDS = 2**18            # 128 subarrays x 2048 words (8 KiB rank row)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
#: The guide's table lists no int32 logic rate; its float32 rate outside
#: the tensor cores is the nearest, and the bytes bound dominates anyway.
CORE_OPS_PER_S = 67e12
GOLDEN = os.path.join(ROOT, "tests", "golden")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def load_golden(name: str):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        return json.load(f)


# -------------------------------------------------------------- timing
class Timer:
    """Median device time of one call, from CUDA events.

    Before each call the L2 cache is flushed (a 128 MiB write) and the
    stream is held by a spin kernel, so the host enqueues the timed work
    while the device is busy: the events then bracket the device time of
    the work alone, not the host's Python overhead.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2**25, dtype=torch.int32, device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    """Largest |difference| of the words read as uint32 (0 = bit-exact)."""
    mask = 0xFFFFFFFF
    d = (got.to(torch.int64) & mask) - (want.to(torch.int64) & mask)
    return int(d.abs().max()) if d.numel() else 0


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vote_ops(x: int) -> int:
    """Logic ops of one carry-save vote over x words (AND+XOR a digit
    per operand, three a digit for the threshold)."""
    digits = x.bit_length()
    return x * digits * 2 + digits * 3


# -------------------------------------------------------------- phases
def phase_build(launch) -> str:
    t0 = time.perf_counter()
    seconds = launch.build_all()
    ptxas = {}
    for name in launch.SOURCES:
        log = launch.library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.split("info    : ")[-1] for ln in lines
                       if "registers" in ln or "spill" in ln]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "nvcc_s": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": ptxas, "card": smi})
    return smi


def phase_kernels(torch, timer) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    from repro_torch.compile import build_schedule, lower_schedule
    from repro_torch.core.bitplanes import from_u32
    from repro_torch.interop import program_from_json
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.megakernel import ops as mega_ops
    from repro_torch.kernels.megakernel.ref import schedule_exec_ref
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    rng = np.random.default_rng(0)

    def words(*shape):
        return from_u32(rng.integers(0, 2**32, shape, dtype=np.uint32),
                        "cuda")

    rows = {}

    def record(name, key, kernel_fn, plain_fn, n_bytes, n_ops, shape,
               library_fn=None):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        check(got.shape == want.shape and err == 0,
              f"{key}: kernel disagrees with its plain version")
        b_ms, b_by = bound(n_bytes, n_ops)
        row = {"name": name, "shape": shape, "max_abs_err": err,
               "ms": timer(kernel_fn), "plain_ms": timer(plain_fn, reps=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timer(library_fn) if library_fn else None}
        emit({"phase": "kernels", "case": key, **row})
        rows[key] = row

    # MAJX: add32's fused-level batch (MAJ3 + MAJ5 padded to X=5, B=2)
    # and maj9_tree's first level (nine MAJ9 votes), at full width.
    for key, x, b in (("majx[add32 level]", 5, 2),
                      ("majx[maj9_tree level]", 9, 9)):
        planes = words(x, b, WORDS)
        record("majx", key, lambda p=planes: majx_ops.majx(p),
               lambda p=planes: majx_ops.majx_ref(p),
               (x + 1) * b * WORDS * 4, b * WORDS * vote_ops(x),
               [x, b, WORDS])

    # Fan-out: one Multi-RowCopy wave of 31 destinations at full width.
    src = words(WORDS)
    record("fanout", "fanout[31]", lambda: rowcopy_ops.fanout(src, 31),
           lambda: rowcopy_ops.fanout_ref(src, 31), 32 * WORDS * 4, 0,
           [31, WORDS], library_fn=lambda: src.unsqueeze(0)
           .expand(31, WORDS).contiguous())

    # Megakernel: the add32 lowering on its 161-row image at full width.
    doc = load_golden("add32")
    low = lower_schedule(build_schedule(
        program_from_json(json.dumps(doc["ops"]))))
    state = words(doc["rows"], WORDS)
    tables = mega_ops.upload_tables(low, "cuda")
    live = sum(sum(m) for m in low.level_meta)
    record("megakernel", "megakernel[add32]",
           lambda: mega_ops.run_lowering(low, state, tables=tables),
           lambda: schedule_exec_ref(low, state),
           2 * (doc["rows"] + 3) * WORDS * 4,
           live * WORDS * (vote_ops(low.x_max) + 1),
           [low.n_levels, low.w_max, low.x_max, doc["rows"], WORDS])
    return rows


def phase_launch_overhead(torch) -> dict:
    """Host wall time (ns) of one 1-word fan-out launch, three ways: the
    wrapper (checks, allocation, launch), ``launch.run`` on a
    preallocated output, and the bare ctypes call on the current stream.
    """
    from repro_torch.kernels import launch
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    src = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    fn = launch.kernel("fanout", "fanout_launch", rowcopy_ops._ARGS)
    stream = launch.VOID_P(torch.cuda.current_stream().cuda_stream)
    ways = {
        "wrapper": lambda: rowcopy_ops.fanout(src, 1),
        "launch_run": lambda: launch.run(
            fn, "fanout", src.device, src.data_ptr(), out.data_ptr(), 1, 1,
            1, 32),
        "ctypes": lambda: fn(src.data_ptr(), out.data_ptr(), 1, 1, 1, 32,
                             stream),
    }
    n = 2000
    ns = {}
    for way, call in ways.items():
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        ns[way] = (time.perf_counter() - t0) / n * 1e9
    emit({"phase": "launch", "launch_overhead_ns": ns, "launches": n})
    return ns


def erase_mrc31(waves: int = 64, fanout: int = 31, words: int = 2048):
    """The full Multi-RowCopy secure-erase workload: ``waves`` MRC waves
    of ``fanout`` rows each from one wipe-pattern row."""
    from repro_torch.pud.isa import Program

    prog = Program()
    prog.emit("WR", tag="erase/pattern")
    row = 1
    for w in range(waves):
        prog.emit("MRC", n_act=fanout + 1, tag=f"erase/wave[{w}]",
                  srcs=(0,), dsts=tuple(range(row, row + fanout)))
        row += fanout
    state = np.zeros((row, words), np.uint32)
    state[0] = 0xDEADBEEF  # the predetermined wipe pattern
    return prog, state


def phase_path(torch, kernel_mods) -> dict:
    """The main path at full width; returns each kernel's launches."""
    from repro_torch.backends import ExecutionContext, get_backend
    from repro_torch.compile import build_schedule
    from repro_torch.core.bitplanes import from_u32, to_u32
    from repro_torch.interop import program_from_json

    cuda = get_backend("cuda", ExecutionContext(device=DEVICE))
    oracle = get_backend("oracle", ExecutionContext(device=DEVICE))
    rng = np.random.default_rng(0)
    workloads = []
    for name in ("add32", "maj9_tree", "mrc_fanout31"):
        doc = load_golden(name)
        prog = program_from_json(json.dumps(doc["ops"]))
        state = rng.integers(0, 2**32, (doc["rows"], WORDS), dtype=np.uint32)
        workloads.append((name, prog, state))
    workloads.append(("erase_mrc31", *erase_mrc31()))

    for mod in kernel_mods.values():
        mod.launches = 0
    start = cuda.dispatch_count
    for name, prog, state in workloads:
        sched = build_schedule(prog)
        state = from_u32(state, DEVICE)
        t0 = time.perf_counter()
        want = oracle.run(prog, state)
        outs, counts, secs = {}, {}, {}
        for mode, fn in (
                ("per_op", lambda: cuda.run(prog, state)),
                ("fused", lambda: cuda.run_fused(prog, state)),
                ("megakernel",
                 lambda: cuda.run_fused(prog, state, mode="megakernel"))):
            # Run twice: the first run pays one-time costs (library and
            # PyTorch kernel loading, table upload); the second is warm.
            for run in ("first", "warm"):
                t1 = time.perf_counter()
                with cuda.count_dispatches() as scope:
                    outs[mode] = fn()
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                secs[f"{mode}/{run}"] = time.perf_counter() - t1
                check(counts.setdefault(mode, scope.count) == scope.count,
                      f"{name}/{mode}: dispatches differ between runs")
                check(torch.equal(outs[mode], want),
                      f"{name}/{mode} disagrees with the oracle")
        check(counts == {"per_op": sched.per_op_dispatches(),
                         "fused": sched.n_dispatches(),
                         "megakernel": 1},
              f"{name}: dispatches {counts}")
        if name == "add32":
            check(counts["fused"] == 34 and counts["megakernel"] == 1,
                  f"add32 dispatches {counts}, want 34 fused, 1 megakernel")
        emit({"phase": "path", "program": name,
              "shape": list(state.shape), "dispatches": counts,
              "host_s": secs, "wall_s": time.perf_counter() - t0,
              "bit_exact": True})

    for path in sorted(glob.glob(os.path.join(GOLDEN, "*.json"))):
        with open(path) as f:
            doc = json.load(f)
        prog = program_from_json(json.dumps(doc["ops"]))
        g = np.random.default_rng((doc["seed"], 0x601D))
        state = g.integers(0, 2**32, (doc["rows"], doc["words"]),
                           dtype=np.uint32)
        expected = np.array([[int(r[i:i + 8], 16) for i in range(0, len(r), 8)]
                             for r in doc["expected"]], np.uint32)
        for mode in ("per_op", "fused", "megakernel"):
            if mode == "per_op":
                got = cuda.run(prog, state)
            else:
                got = cuda.run_fused(prog, state, mode=mode)
            check((to_u32(got) == expected).all(),
                  f"golden {doc['name']}/{mode} != expected")
    emit({"phase": "path", "goldens": "7 replayed x 3 modes, bit-exact"})

    launches = {n: m.launches for n, m in kernel_mods.items()}
    dispatches = cuda.dispatch_count - start
    check(sum(launches.values()) == dispatches,
          f"kernel launches {launches} != backend dispatches {dispatches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was never launched: {launches}")
    emit({"phase": "path", "launches": launches, "dispatches": dispatches})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import launch
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.megakernel import ops as mega_ops
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    kernel_mods = {"majx": majx_ops, "fanout": rowcopy_ops,
                   "megakernel": mega_ops}

    smi = phase_build(launch)
    timer = Timer(torch)
    rows = phase_kernels(torch, timer)
    phase_launch_overhead(torch)
    launches = phase_path(torch, kernel_mods)

    replaces = {
        "majx": "src/repro/kernels/majx/kernel.py:74",
        "fanout": "src/repro/kernels/rowcopy/kernel.py:27",
        "megakernel": "src/repro/kernels/megakernel/kernel.py:65",
    }
    main_case = {"majx": "majx[maj9_tree level]", "fanout": "fanout[31]",
                 "megakernel": "megakernel[add32]"}
    kernels = []
    for name, key in main_case.items():
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
