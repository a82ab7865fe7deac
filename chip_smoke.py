#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

The first path is program execution: an addressed ``Program`` is
scheduled into dependency levels, lowered to megakernel tables, and run
by the ``cuda`` backend per op, level-fused and as one megakernel launch.
The second is the typed session: ``DramSession()`` builds, validates,
compile-caches and certifies a program, runs it on the card, and checks
what came out with the success-rate counter (the mismatch kernel).  The
third is §8.1 arithmetic: ``DramSession().elementwise`` traces a
bit-serial gate stream into a Program and runs it fused (or as one
megakernel launch), and ``add_planes`` runs the bulk bit-serial adder.
Phases, one JSON line each:

1. build — compile the CUDA kernels of ``src/repro_torch/csrc`` with
   nvcc (all sources at once) and print the card's name and power limit;
2. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, bit-exact, with median times;
   the megakernel at add32 and at the largest §8.1 lowerings (mul at
   tier 5 over 2**18 words, div at MAJ3 over 2048), in the regime its
   planner picks and, where it fits, the other one, also held to the
   padded tables' walk;
3. path — the ``add32``, ``maj9_tree`` and ``mrc_fanout31`` golden
   Programs at 2**18 words a row (one DDR4 bank: 128 subarrays of one
   8 KiB rank row), plus the full ``erase_mrc31`` Multi-RowCopy wipe,
   per-op == fused == megakernel == the ``oracle`` backend, and the
   seven golden Programs at their own width against their frozen
   expected rows;
4. session — through ``DramSession()`` at 2**18 words a row: a
   serve-style TMR heal vote (three replicas of 32 rows with known,
   disjoint bit flips) in fused and megakernel mode, and the
   ``erase_mrc31`` wipe built with the session's builder, each checked
   by ``session.mismatch`` / ``success_rate`` against the known flips;
   the second run of a program must hit all three compile-cache
   windows, and a malformed Program must be refused before any launch;
5. arith — through ``DramSession()``: add, sub and mul at 2**18 words a
   plane (2**23 lanes) fused and as a megakernel, exact against numpy,
   with the trace, upload and warm wall times and the offload planner's
   verdict; all seven ops at tiers 3/5/7/9 at 2048 words (one 8 KiB
   rank row); ``add_planes`` at full width; the add8/16/32 goldens
   re-traced; then ``add_u32`` at 2**23 elements;
6. the kernels line, then ``{"ok": true, ...}`` as the last line.

Every kernel's launch count is zeroed just before phases 3, 4 and 5 and
read just after each: the launches must add up to the backend's
dispatches, and every kernel of the phase's path must have launched.
Any failed check raises, so the script exits non-zero and prints no
result.  It needs ``torch.cuda.is_available()`` and the repository's
``src/`` and ``tests/golden/`` beside it.
"""

from __future__ import annotations

import dataclasses
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
RANK_WORDS = 2048        # one 8 KiB rank row
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
def megakernel_cost(plan, rows: int, words: int) -> dict:
    """What one megakernel launch of ``plan`` on a (rows, words) image
    must and may cost: the bound (the program rows read once and written
    once; the three constant rows are made on the card, not moved; the
    kept slots' votes as operations), and the traffic of the kept slots
    (every kept operand read and every destination written once a
    column) beside it."""
    arity = plan.arity.tolist()
    n_bytes = 2 * rows * words * 4
    n_ops = sum(vote_ops(k) for k in arity) * words
    kept = (sum(arity) + len(arity)) * words * 4
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "kept_slot_traffic_ms": kept / HBM_BYTES_PER_S * 1e3,
            "levels": plan.n_levels, "kept_slots": plan.n_slots,
            "n_bytes": n_bytes, "n_ops": n_ops}


def megakernel_case(torch, record, key, timer, low, state,
                    cols=None) -> None:
    """Time one megakernel launch of ``low`` on ``state`` (tables on the
    card) against its plain version, the walk of the same plan, and hold
    it to the padded walk of the tables: on the whole image, or on its
    first and last ``cols`` columns (word columns are independent).  The
    regime the planner did not pick is timed beside it where it fits."""
    from repro_torch.kernels.megakernel import ops as mega_ops
    from repro_torch.kernels.megakernel.plan import (exec_plan_ref,
                                                     plan_launch)
    from repro_torch.kernels.megakernel.ref import schedule_exec_ref

    tables = mega_ops.upload_tables(low, "cuda")
    plan = tables.plan
    rows, words = state.shape
    lp = plan_launch(plan, rows, words)

    def oracle(got):
        if cols is None or 2 * cols >= words:
            return max_abs_err(torch, got, schedule_exec_ref(low, state))
        err = 0
        for sl in (slice(0, cols), slice(words - cols, words)):
            want = schedule_exec_ref(low, state[:, sl].contiguous())
            err = max(err, max_abs_err(torch, got[:, sl], want))
        return err

    # The regime the planner did not pick, where it fits: the evidence
    # for its choice, timed in the same run.
    other = "streaming" if lp.regime == "resident" else "resident"
    try:
        plan_launch(plan, rows, words, regime=other)
    except ValueError:
        other_ms = None
    else:
        def run_other():
            return mega_ops.run_lowering(low, state, tables=tables,
                                         regime=other)
        check(torch.equal(run_other(), mega_ops.run_lowering(
            low, state, tables=tables)), f"{key}: the regimes disagree")
        other_ms = timer(run_other, reps=5 if cols else 15)

    cost = megakernel_cost(plan, rows, words)
    record("megakernel", key,
           lambda: mega_ops.run_lowering(low, state, tables=tables),
           lambda: exec_plan_ref(plan, state), cost["n_bytes"],
           cost["n_ops"], [low.n_levels, low.w_max, low.x_max, rows, words],
           reps=5 if cols else 15, oracle=oracle,
           extra={"regime": lp.regime, "strip": lp.strip,
                  "threads": lp.threads, "smem_bytes": lp.smem_bytes,
                  "other_regime": other, "other_regime_ms": other_ms,
                  "oracle_cols": cols or words,
                  **{k: cost[k] for k in ("kept_slot_traffic_ms",
                                          "levels", "kept_slots")}})


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
    from repro_torch.compile import (build_schedule, compile_elementwise,
                                     lower_schedule)
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.bitplanes import from_u32
    from repro_torch.interop import program_from_json
    from repro_torch.kernels.bitserial import ops as bitserial_ops
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.mismatch import ops as mismatch_ops
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    rng = np.random.default_rng(0)

    def words(*shape):
        return from_u32(rng.integers(0, 2**32, shape, dtype=np.uint32),
                        "cuda")

    rows = {}

    def record(name, key, kernel_fn, plain_fn, n_bytes, n_ops, shape,
               library_fn=None, reps=15, oracle=None, extra=None):
        """``oracle(got)`` returns a further max_abs_err of the kernel's
        output against an independent reference."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if oracle is not None:
            err = max(err, oracle(got))
        check(got.shape == want.shape and err == 0,
              f"{key}: kernel disagrees with its plain version")
        del got, want
        b_ms, b_by = bound(n_bytes, n_ops)
        row = {"name": name, "shape": shape, "max_abs_err": err,
               "ms": timer(kernel_fn, reps=reps),
               "plain_ms": timer(plain_fn, reps=min(reps, 5)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timer(library_fn) if library_fn else None,
               **(extra or {})}
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

    # Megakernel: the add32 lowering on its 161-row image at full width,
    # then the largest §8.1 lowerings, mul at tier 5 over one bank and
    # div at MAJ3 over one rank row.  The plain version is the walk of
    # the same plan; the padded tables' walk (schedule_exec_ref) is the
    # oracle, on column slices where the full image would take minutes.
    doc = load_golden("add32")
    low = lower_schedule(build_schedule(
        program_from_json(json.dumps(doc["ops"]))))
    megakernel_case(torch, record, "megakernel[add32]", timer, low,
                    words(doc["rows"], WORDS))
    for op, tier, width in (("mul", 5, WORDS), ("div", 3, RANK_WORDS)):
        a, b = rng.integers(0, 2**32, (2, width * 32), dtype=np.uint32)
        b[::61] = 0
        cp = compile_elementwise(op, a, b, tier=tier, n_act=32)
        low = lower_schedule(build_schedule(cp.program))
        megakernel_case(torch, record, f"megakernel[{op} tier {tier}]",
                        timer, low, from_u32(cp.state, "cuda"), cols=512)
        del cp

    # Mismatch: two add32 images at full width (the success-rate check
    # of a whole run's output), then two exact cases: a known number of
    # set bits, and 2**31 differing bits, where the int32 count wraps.
    n = doc["rows"] * WORDS
    got, want = words(n), words(n)
    record("mismatch", "mismatch[add32 image]",
           lambda: mismatch_ops.mismatch_count(got, want),
           lambda: mismatch_ops.mismatch_count_ref(got, want),
           2 * n * 4, 3 * n, [doc["rows"], WORDS])
    pos = np.unique(rng.integers(0, n * 32, 1_000_003))
    flips = np.zeros(n, np.uint32)
    np.bitwise_or.at(flips, pos // 32,
                     (np.uint32(1) << (pos % 32)).astype(np.uint32))
    got, want = torch.zeros_like(want), from_u32(flips, "cuda")
    record("mismatch", "mismatch[exact]",
           lambda: mismatch_ops.mismatch_count(got, want),
           lambda: mismatch_ops.mismatch_count_ref(got, want),
           2 * n * 4, 3 * n, [doc["rows"], WORDS], reps=3)
    check(int(mismatch_ops.mismatch_count(got, want)) == len(pos),
          f"mismatch[exact]: want {len(pos)} differing bits")
    del got, want, flips
    zeros = torch.zeros(2**26, dtype=torch.int32, device="cuda")
    ones = torch.full_like(zeros, -1)
    record("mismatch", "mismatch[wrap]",
           lambda: mismatch_ops.mismatch_count(ones, zeros),
           lambda: mismatch_ops.mismatch_count_ref(ones, zeros),
           2 * 2**26 * 4, 3 * 2**26, [2**26], reps=3)
    wrapped = int(bp.wrap_i32(torch.tensor(2**31, dtype=torch.int64)))
    check(int(mismatch_ops.mismatch_count(ones, zeros)) == wrapped
          == -2**31, "mismatch[wrap]: 2**31 bits must wrap to -2**31")
    del zeros, ones

    # Bit-serial add: two 32-bit operands over one bank (add_planes'
    # (NBITS, R, C) layout), an odd word count (the single-word path) and
    # 33 planes (a ragged last group of planes).  Six logic ops a word a
    # plane (two XOR for the sum, four for the majority carry).
    for key, shape in (("bitserial[bank]", (32, 128, RANK_WORDS)),
                       ("bitserial[odd words]", (32, WORDS + 3)),
                       ("bitserial[nbits 33]", (33, 128, RANK_WORDS))):
        a, b = words(*shape), words(*shape)
        n = a.numel()
        record("bitserial", key, lambda a=a, b=b: bitserial_ops.bitserial_add(
            a, b), lambda a=a, b=b: bitserial_ops.bitserial_add_ref(a, b),
            3 * n * 4, 6 * n, list(shape))
    return rows


def phase_launch_overhead(torch) -> dict:
    """Host wall time (ns) of one 1-word fan-out launch, three ways: the
    wrapper (checks, allocation, launch), ``launch.run`` with the entry
    point looked up through ``launch.kernel`` on a preallocated output,
    and the bare ctypes call on the current stream.
    """
    from repro_torch.kernels import launch
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    src = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    fn = launch.kernel("fanout", "fanout_launch", rowcopy_ops._ARGS)
    stream = launch.VOID_P(torch.cuda.current_stream().cuda_stream)

    def launch_run():
        launch.run(launch.kernel("fanout", "fanout_launch",
                                 rowcopy_ops._ARGS), "fanout", src.device,
                   src.data_ptr(), out.data_ptr(), 1, 1, 1, 32)

    ways = {
        "wrapper": lambda: rowcopy_ops.fanout(src, 1),
        "launch_run": launch_run,
        "ctypes": lambda: fn(src.data_ptr(), out.data_ptr(), 1, 1, 1, 32,
                             stream),
    }
    n = 2000
    ns = {}
    for way, call in list(ways.items()) * 2:   # in turns, twice
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        ns.setdefault(way, []).append((time.perf_counter() - t0) / n * 1e9)
    ns = {way: min(t) for way, t in ns.items()}
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


def zero_launches(kernel_mods) -> None:
    for mod in kernel_mods.values():
        mod.launches = 0


def read_launches(kernel_mods, path_kernels, dispatches: int,
                  phase: str) -> dict:
    """Each kernel's launches since :func:`zero_launches`; they must add
    up to the backend's ``dispatches``, and every kernel in
    ``path_kernels`` must have launched."""
    launches = {n: m.launches for n, m in kernel_mods.items()}
    check(sum(launches.values()) == dispatches,
          f"{phase}: kernel launches {launches} != backend dispatches "
          f"{dispatches}")
    check(all(launches[n] > 0 for n in path_kernels),
          f"{phase}: a kernel of the path was never launched: {launches}")
    emit({"phase": phase, "launches": launches, "dispatches": dispatches})
    return launches


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

    zero_launches(kernel_mods)
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

    return read_launches(kernel_mods, ("majx", "fanout", "megakernel"),
                         cuda.dispatch_count - start, "path")


def new_session(name: str):
    """A ``DramSession`` on the card — the user's default — or, for a
    rehearsal with ``DEVICE`` set to ``"cpu"``, on the CPU."""
    from repro_torch.backends import ExecutionContext
    from repro_torch.session import DramSession

    if DEVICE == "cuda":
        return DramSession(name=name)
    return DramSession("cuda", ExecutionContext(device=DEVICE), name=name)


def flip_bits(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """A copy of ``words`` with the distinct flat bit positions ``pos``
    flipped."""
    out = words.copy()
    np.bitwise_xor.at(out.reshape(-1), pos // 32,
                      (np.uint32(1) << (pos % 32)).astype(np.uint32))
    return out


def timed_runs(torch, sess, prog, state, modes=("fused", "megakernel")):
    """Run ``prog`` twice per mode through the session; returns the
    outputs, the dispatches of each mode and the host wall of each run
    (the first pays scheduling, lowering, certification, table upload
    and the image upload; the warm one hits every cache)."""
    outs, counts, secs = {}, {}, {}
    for mode in modes:
        for run in ("first", "warm"):
            before = tuple(dataclasses.replace(w) for w in (
                sess.cache.stats, sess.cache.lowering_stats,
                sess.cache.certificate_stats))
            t0 = time.perf_counter()
            with sess.count_dispatches() as scope:
                out = sess.run_fused(prog, state, mode=mode)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            secs[f"{mode}/{run}"] = time.perf_counter() - t0
            check(counts.setdefault(mode, scope.count) == scope.count,
                  f"{mode}: dispatches differ between runs")
            if run == "first":
                outs[mode] = out
                continue
            check(torch.equal(out, outs[mode]), f"{mode}: runs differ")
            after = (sess.cache.stats, sess.cache.lowering_stats,
                     sess.cache.certificate_stats)
            deltas = [(a.hits - b.hits, a.misses - b.misses)
                      for a, b in zip(after, before)]
            want = [(1, 0), (1 if mode == "megakernel" else 0, 0), (1, 0)]
            check(deltas == want, f"{mode}: warm run's cache deltas "
                  f"(schedule, lowering, certificate) {deltas} != {want}")
    return outs, counts, secs


def certify_seconds(prog) -> float:
    """Host wall of one fresh certification (races, liveness, symbolic
    equivalence) of ``prog`` with its schedule and lowering."""
    from repro_torch.analyze import certify
    from repro_torch.compile import build_schedule, lower_schedule

    sched = build_schedule(prog)
    low = lower_schedule(sched)
    t0 = time.perf_counter()
    certify(prog, sched=sched, lowering=low)
    return time.perf_counter() - t0


def phase_session(torch, kernel_mods) -> dict:
    """The typed session path at full width; returns each kernel's
    launches."""
    from repro_torch.backends import get_backend
    from repro_torch.core import calibration as cal
    from repro_torch.core.bitplanes import from_u32
    from repro_torch.interop import program_from_json
    from repro_torch.pud.isa import Program
    from repro_torch.session import ProgramValidationError

    sess = new_session("smoke")
    check(sess.backend.name == "cuda" and sess.ctx.certify,
          "DramSession() must resolve the certified cuda backend")
    oracle = get_backend("oracle", sess.ctx)
    rng = np.random.default_rng(1)
    zero_launches(kernel_mods)
    start = sess.dispatch_count

    # Heal: a TMR vote over three replicas of 32 rows, as serve's heal
    # batch builds it, each replica with its own known bit flips at
    # positions no other replica flips.
    t0 = time.perf_counter()
    rows, x = 32, 3
    clean = rng.integers(0, 2**32, (rows, WORDS), dtype=np.uint32)
    n_bits = rows * WORDS * 32
    sizes = (1000, 1017, 1034)
    flips = np.split(rng.choice(n_bits, sum(sizes), replace=False),
                     np.cumsum(sizes)[:-1])
    reps = [flip_bits(clean, f) for f in flips]
    b = sess.program(rows=(x + 1) * rows, name="smoke/heal-x3")
    groups = [b.input(r, tag=f"heal/replica[{j}]")
              for j, r in enumerate(reps)]
    voted = b.alloc_rows(rows, tag="heal/voted")
    n_act = cal.min_activation_for(32)
    for r in range(rows):
        b.maj(*(g[r] for g in groups), dst=voted[r], n_act=n_act,
              tag=f"heal/row[{r}]")
    prog = b.build()
    state = b.initial_state()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_u32(state, DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    outs, counts, secs = timed_runs(torch, sess, prog, state)
    want = oracle.run(prog, state)
    check(all(torch.equal(o, want) for o in outs.values()),
          "heal: fused / megakernel disagree with the oracle")
    tile = outs["megakernel"][list(voted.indices)]
    check(torch.equal(tile, from_u32(clean, DEVICE)),
          "heal: the voted rows are not the clean rows")
    replica0 = from_u32(reps[0], DEVICE)
    t0 = time.perf_counter()
    fixed = int(sess.mismatch(replica0, tile))
    mismatch_s = time.perf_counter() - t0
    rate = sess.success_rate(replica0, tile)
    check(fixed == len(flips[0]),
          f"heal: mismatch {fixed} != {len(flips[0])} flipped bits")
    check(rate == 1.0 - len(flips[0]) / n_bits,
          f"heal: success rate {rate}")
    check(counts == {"fused": 1, "megakernel": 1},
          f"heal: dispatches {counts}, want one MAJX level / one launch")
    emit({"phase": "session", "workload": "heal", "shape": list(
        state.shape), "image_mib": state.nbytes / 2**20,
        "dispatches": counts, "host_s": secs, "build_s": build_s,
        "upload_s": upload_s,
        "certify_s": certify_seconds(prog), "mismatch_bits": fixed,
        "mismatch_host_s": mismatch_s, "success_rate": rate})

    # Erase: erase_mrc31's 64 waves of 31 rows from one pattern row,
    # built through the session's builder.
    waves, fanout, width = 64, 31, 2048
    b = sess.program(rows=waves * fanout + 1, name="smoke/erase-f31")
    src = b.input(np.full(width, 0xDEADBEEF, np.uint32),
                  tag="erase/pattern")
    dsts = b.alloc_rows(waves * fanout, tag="erase/wiped")
    for lo in range(0, waves * fanout, fanout):
        b.mrc(src, dsts[lo:lo + fanout], tag=f"erase/wave[{lo // fanout}]")
    prog = b.build()
    state = b.initial_state()
    outs, counts, secs = timed_runs(torch, sess, prog, state)
    want = oracle.run(prog, state)
    check(all(torch.equal(o, want) for o in outs.values()),
          "erase: fused / megakernel disagree with the oracle")
    wiped = outs["megakernel"][list(dsts.indices)]
    pattern = outs["megakernel"][src.index].expand_as(wiped).contiguous()
    check(int(sess.mismatch(wiped, pattern)) == 0,
          "erase: the wiped rows differ from the pattern")
    j_pos = rng.choice(wiped.numel() * 32, 777, replace=False)
    flipped = from_u32(flip_bits(np.zeros(tuple(wiped.shape), np.uint32),
                                 j_pos), DEVICE) ^ wiped
    bad = int(sess.mismatch(flipped, pattern))
    check(bad == len(j_pos), f"erase: mismatch {bad} != {len(j_pos)}")
    check(counts == {"fused": 1, "megakernel": 1},
          f"erase: dispatches {counts}, want one fan-out / one launch")
    emit({"phase": "session", "workload": "erase_mrc31",
          "shape": list(state.shape), "dispatches": counts,
          "host_s": secs, "certify_s": certify_seconds(prog),
          "mismatch_bits": bad})

    # Certification of the largest golden program, for scale.
    add32 = program_from_json(json.dumps(load_golden("add32")["ops"]))
    emit({"phase": "session", "workload": "add32",
          "certify_s": certify_seconds(add32)})

    # Validation before launch: a hand-built Program with a row outside
    # the image is refused, and nothing is dispatched.
    bad_prog = Program()
    bad_prog.emit("MAJ", x=3, n_act=4, tag="smoke/far",
                  srcs=(0, 1, 999), dsts=(2,))
    small = from_u32(np.zeros((4, WORDS), np.uint32), DEVICE)
    before = sess.dispatch_count
    for mode in ("fused", "megakernel"):
        try:
            sess.run_fused(bad_prog, small, mode=mode)
        except ProgramValidationError as err:
            check("999" in str(err), f"validation message: {err}")
        else:
            raise AssertionError("an out-of-range row was not refused")
    check(sess.dispatch_count == before,
          "a refused program dispatched kernels")
    emit({"phase": "session", "validation": "out-of-range row refused "
          "before any launch"})
    return read_launches(kernel_mods,
                         ("majx", "fanout", "megakernel", "mismatch"),
                         sess.dispatch_count - start, "session")


def _numpy_op(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy's uint32 arithmetic for a §8.1 op; division by zero gives
    the reference's convention (quotient all ones)."""
    if op == "div":
        safe = np.where(b == 0, 1, b)
        return np.where(b == 0, np.uint32(0xFFFFFFFF), a // safe)
    return {"and": np.bitwise_and, "or": np.bitwise_or,
            "xor": np.bitwise_xor, "add": np.add, "sub": np.subtract,
            "mul": np.multiply}[op](a, b).astype(np.uint32)


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def phase_arith(torch, kernel_mods, timer=None) -> dict:
    """§8.1 arithmetic through ``DramSession()``; returns each kernel's
    launches.  With a :class:`Timer`, the megakernel launches of add and
    mul at full width and of the largest 2048-word program are timed on
    the card afterwards, outside the counted window."""
    from repro_torch.compile import (build_schedule, compile_elementwise,
                                     lower_schedule, trace_planes)
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.bitplanes import from_u32, to_u32
    from repro_torch.kernels.bitserial import ops as bitserial_ops
    from repro_torch.kernels.megakernel import ops as mega_ops
    from repro_torch.kernels.megakernel.plan import plan_launch
    from repro_torch.pud.arith import OPS
    from repro_torch.pud.offload import plan_program

    sess = new_session("smoke/arith")
    to_time = {}        # case -> CompiledProgram, timed after the window
    rng = np.random.default_rng(2)
    zero_launches(kernel_mods)
    start = sess.dispatch_count

    # Packing 2**23 lanes into 32 planes and back: on the host, where the
    # tracer packs the operands, and on the card, where the results are
    # unpacked from the final image.
    lanes = WORDS * 32
    a, b = rng.integers(0, 2**32, (2, lanes), dtype=np.uint32)
    packing = {}
    for where in ("cpu", DEVICE):
        x = from_u32(a, where)
        _sync(torch)
        t0 = time.perf_counter()
        planes = bp.pack_uint_elements(x)
        _sync(torch)
        t1 = time.perf_counter()
        back = bp.unpack_uint_elements(planes, lanes)
        _sync(torch)
        packing[where] = {"pack_s": t1 - t0,
                          "unpack_s": time.perf_counter() - t1}
        check(torch.equal(back, x), f"pack/unpack on {where} round trip")
    del x, planes, back
    emit({"phase": "arith", "packing": packing, "lanes": lanes})

    # Full width: add, sub, mul at tier 5 over one bank.
    rows_want = {"add": 161, "sub": 193, "mul": 2177}
    walls = {}
    for op in ("add", "sub", "mul"):
        want = _numpy_op(op, a, b)
        t0 = time.perf_counter()
        cp = compile_elementwise(op, a, b, tier=5, n_act=32)
        trace_s = time.perf_counter() - t0
        check(cp.state.shape == (rows_want[op], WORDS),
              f"{op}: image {cp.state.shape}")
        sched = build_schedule(cp.program)
        t0 = time.perf_counter()
        from_u32(cp.state, DEVICE)
        _sync(torch)
        upload_s = time.perf_counter() - t0
        # The user's entry point: traced, then run fused by the session.
        t0 = time.perf_counter()
        with sess.count_dispatches() as scope:
            out, prog = sess.elementwise(op, a, b, tier=5, n_act=32)
        _sync(torch)
        elementwise_s = time.perf_counter() - t0
        check((to_u32(out) == want).all(), f"{op}: elementwise != numpy")
        check(scope.count == sched.n_dispatches(),
              f"{op}: {scope.count} fused dispatches, schedule says "
              f"{sched.n_dispatches()}")
        check(prog.to_json() == cp.program.to_json(),
              f"{op}: elementwise traced another Program")
        if op == "add":
            before = dataclasses.replace(sess.cache.stats)
            again, _ = sess.elementwise(op, a, b, tier=5, n_act=32)
            check(torch.equal(again, out), "add: a repeated call differs")
            check((sess.cache.stats.hits - before.hits,
                   sess.cache.stats.misses - before.misses) == (1, 0),
                  "add: a repeated call must hit the compile cache")
            del again
        outs, counts, secs = timed_runs(torch, sess, cp.program, cp.state)
        for mode, final in outs.items():
            check((to_u32(cp.outputs(final)) == want).all(),
                  f"{op}/{mode} != numpy")
        check(counts == {"fused": sched.n_dispatches(), "megakernel": 1},
              f"{op}: dispatches {counts}")
        if op == "add":
            check(counts["fused"] == 34, f"add: {counts['fused']} fused "
                  "dispatches, want 34")
        walls[op] = secs
        emit({"phase": "arith", "op": op, "tier": 5, "words": WORDS,
              "ops": len(cp.program.ops), "levels": sched.n_levels,
              "rows": cp.state.shape[0],
              "image_mib": cp.state.nbytes / 2**20, "dispatches": counts,
              "trace_s": trace_s, "upload_s": upload_s,
              "elementwise_s": elementwise_s, "host_s": secs,
              "exact": True})
        if op in ("add", "mul"):
            d = plan_program(cp.program, WORDS * 4, ctx=sess.ctx,
                             sched=sess.schedule_for(cp.program))
            emit({"phase": "arith", "offload": op, "gpu_ns": d.gpu_ns,
                  "pud_ns": d.pud_ns, "winner": d.winner,
                  "gpu_energy_nj": d.gpu_energy_nj,
                  "pud_energy_nj": d.pud_energy_nj,
                  "winner_energy": d.winner_energy, "detail": d.detail,
                  "measured_warm_s": {m: secs[f"{m}/warm"]
                                      for m in ("fused", "megakernel")}})
            to_time[f"{op}[tier 5, {WORDS} words]"] = cp
        del cp, outs, out

    # Every op at every tier over one rank row, fused and megakernel.
    lanes = RANK_WORDS * 32
    a, b = rng.integers(0, 2**32, (2, lanes), dtype=np.uint32)
    b[::61] = 0                # division by zero
    b[1::59] = a[1::59]        # equal operands
    b[2::53] = rng.integers(0, 2**8, len(b[2::53]), dtype=np.uint32)
    largest = None
    for tier in (3, 5, 7, 9):
        for op in OPS:
            want = _numpy_op(op, a, b)
            t0 = time.perf_counter()
            with sess.count_dispatches() as scope:
                out, prog = sess.elementwise(op, a, b, tier=tier, n_act=32)
            _sync(torch)
            fused_s = time.perf_counter() - t0
            check((to_u32(out) == want).all(),
                  f"{op}/MAJ{tier} at {RANK_WORDS} words != numpy")
            sched = build_schedule(prog)
            check(scope.count == sched.n_dispatches(),
                  f"{op}/MAJ{tier}: {scope.count} fused dispatches, "
                  f"schedule says {sched.n_dispatches()}")
            cp = compile_elementwise(op, a, b, tier=tier, n_act=32)
            t0 = time.perf_counter()
            with sess.count_dispatches() as scope:
                final = sess.run_fused(cp.program, cp.state,
                                       mode="megakernel")
            _sync(torch)
            mega_s = time.perf_counter() - t0
            check(scope.count == 1, f"{op}/MAJ{tier}: megakernel took "
                  f"{scope.count} dispatches")
            check((to_u32(cp.outputs(final)) == want).all(),
                  f"{op}/MAJ{tier} megakernel != numpy")
            row = {"phase": "arith", "op": op, "tier": tier,
                   "words": RANK_WORDS, "ops": len(prog.ops),
                   "levels": sched.n_levels, "rows": cp.state.shape[0],
                   "dispatches": {"fused": sched.n_dispatches(),
                                  "megakernel": 1},
                   "elementwise_s": fused_s, "megakernel_first_s": mega_s,
                   "exact": True}
            emit(row)
            if largest is None or row["ops"] > largest["ops"]:
                largest, largest_cp = row, cp
    check((largest["op"], largest["tier"], largest["ops"]) ==
          ("div", 3, 14784), f"largest program {largest}")
    to_time[f"div[tier 3, {RANK_WORDS} words]"] = largest_cp
    emit({"phase": "arith", "largest": "div", "tier": 3,
          "certify_s": certify_seconds(largest_cp.program)})

    # The bulk adder: one launch a call, bit-exact.
    shapes = ((32, 128, RANK_WORDS), (32, WORDS))
    for shape in shapes:
        pa = from_u32(rng.integers(0, 2**32, shape, dtype=np.uint32), DEVICE)
        pb = from_u32(rng.integers(0, 2**32, shape, dtype=np.uint32), DEVICE)
        with sess.count_dispatches() as scope:
            got = sess.add_planes(pa, pb)
        check(scope.count == 1, f"add_planes{shape}: {scope.count} "
              "dispatches")
        check(torch.equal(got, bitserial_ops.bitserial_add_ref(pa, pb)),
              f"add_planes{shape} != bitserial_add_ref")
    emit({"phase": "arith", "add_planes": [list(s) for s in shapes],
          "launches_each": 1, "bit_exact": True})

    # The add8/16/32 goldens, re-traced from their generator's seeds
    # (tests/golden/generate.py, _adder) without JAX.
    for nbits in (8, 16, 32):
        doc = load_golden(f"add{nbits}")
        g = np.random.default_rng(nbits)
        A = bp.pack(torch.from_numpy(g.integers(0, 2, (nbits, doc["words"]
                                                       * 32)).astype(bool)))
        B = bp.pack(torch.from_numpy(g.integers(0, 2, (nbits, doc["words"]
                                                       * 32)).astype(bool)))
        cp = trace_planes(lambda bs: list(bs.add(A, B)[0]), tier=5,
                          n_act=32)
        check(json.loads(cp.program.to_json()) == doc["ops"],
              f"add{nbits}: the re-traced Program differs from the golden")
        check(cp.state.shape[0] == doc["rows"], f"add{nbits}: rows")
    emit({"phase": "arith", "goldens": "add8/add16/add32 re-traced, "
          "equal to the frozen ops"})

    launches = read_launches(kernel_mods, ("majx", "megakernel",
                                           "bitserial"),
                             sess.dispatch_count - start, "arith")

    # add_u32 at 2**23 elements, outside the counted window: it calls the
    # wrapper directly, so no backend counts its dispatch.
    x, y = rng.integers(0, 2**32, (2, WORDS * 32), dtype=np.uint32)
    before = bitserial_ops.launches
    got = bitserial_ops.add_u32(from_u32(x, DEVICE), from_u32(y, DEVICE))
    check(bitserial_ops.launches == before + (DEVICE == "cuda"),
          "add_u32: one launch")
    check((to_u32(got) == x + y).all(), "add_u32 != numpy")
    emit({"phase": "arith", "add_u32": "2**23 elements, one launch, exact"})

    # Device time of one megakernel launch per case (image already on
    # the card, plan uploaded), beside its bound and the traffic of the
    # kept slots, and the bytes the padded tables would move.
    for case, cp in to_time.items():
        if timer is None:
            break
        low = lower_schedule(build_schedule(cp.program))
        tables = mega_ops.upload_tables(low, DEVICE)
        state = from_u32(cp.state, DEVICE)
        rows, words = state.shape
        slots = low.n_levels * low.w_max
        cost = megakernel_cost(tables.plan, rows, words)
        emit({"phase": "arith", "megakernel_device": case,
              "ms": timer(lambda: mega_ops.run_lowering(
                  low, state, tables=tables), reps=3, warmup=1),
              "regime": plan_launch(tables.plan, rows, words).regime,
              "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
              "kept_slot_traffic_ms": cost["kept_slot_traffic_ms"],
              "levels": low.n_levels, "plan_levels": cost["levels"],
              "w_max": low.w_max, "x_max": low.x_max,
              "live_slots": int(sum(map(sum, low.level_meta))),
              "kept_slots": cost["kept_slots"], "padded_slots": slots,
              "padded_traffic_ms": bound(slots * (low.x_max + 3) * words * 4,
                                         0)[0]})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import launch
    from repro_torch.kernels.bitserial import ops as bitserial_ops
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.megakernel import ops as mega_ops
    from repro_torch.kernels.mismatch import ops as mismatch_ops
    from repro_torch.kernels.rowcopy import ops as rowcopy_ops

    kernel_mods = {"majx": majx_ops, "fanout": rowcopy_ops,
                   "megakernel": mega_ops, "mismatch": mismatch_ops,
                   "bitserial": bitserial_ops}

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    smi = timed("build", phase_build, launch)
    timer = Timer(torch)
    rows = timed("kernels", phase_kernels, torch, timer)
    timed("launch", phase_launch_overhead, torch)
    path = timed("path", phase_path, torch, kernel_mods)
    session = timed("session", phase_session, torch, kernel_mods)
    arith = timed("arith", phase_arith, torch, kernel_mods, timer)
    emit({"phase": "walls", "seconds": walls})

    replaces = {
        "majx": "src/repro/kernels/majx/kernel.py:74",
        "fanout": "src/repro/kernels/rowcopy/kernel.py:27",
        "megakernel": "src/repro/kernels/megakernel/kernel.py:65",
        "mismatch": "src/repro/kernels/mismatch/kernel.py:38",
        "bitserial": "src/repro/kernels/bitserial/kernel.py:38",
    }
    main_case = {"majx": "majx[maj9_tree level]", "fanout": "fanout[31]",
                 "megakernel": "megakernel[add32]",
                 "mismatch": "mismatch[add32 image]",
                 "bitserial": "bitserial[bank]"}
    kernels = []
    for name, key in main_case.items():
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": path[name] + session[name] + arith[name],
            "launches_by_path": {"path": path[name],
                                 "session": session[name],
                                 "arith": arith[name]},
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
