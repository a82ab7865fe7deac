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
The fourth is the multi-tenant service: ``PudService()`` batches heal,
erase and integrity requests into fused Programs over a pool of
sessions.  The fifth is the TMR checkpoint store, which votes replicas
of a tree on the card with the MAJX kernel.  The sixth is the paper's
own subject: the behavioural device model (``Subarray``, the ``sim``
backend, threefry draws word for word with jax) and the
characterization sweep (``run_sweep`` and its CLI).  The seventh is the
same sweep run fault-tolerantly (``run_sweep_ft``: worker threads with
elastic membership and straggler re-dispatch) and placed over a device
mesh.  The eighth is LM serving: ``Engine.generate`` over models of
every family at their published widths, whose ``heal_params`` /
``verify_params`` run through the service.  The ninth is training:
``Trainer.run`` (data pipeline, ``loss_fn`` under remat, autograd,
gradient compression, AdamW) at the published width and depth of two
models, and ``python -m repro_torch.launch.train``'s restart from a TMR
checkpoint store that the MAJX kernel votes.
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
6. serve — ``PudService()`` (the card, ideal context, two sessions)
   serves one tick of 16 heals (3 replicas x 8 rows), 16 erases (31
   rows, fan-out 31) and 16 integrity checks (8 rows) at 2**18 words a
   row, coalesced (1 MAJX + 1 fan-out + 32 mismatch launches a round)
   and sequential (16 + 16 + 32): a warm-up round, ``reset_slo()``, two
   timed rounds each, then six requests through ``start`` / ``submit``
   / ``stop``; every result is checked against the planted flips, and
   the SLO snapshot (throughput, p50/p99, batches, occupancy,
   dispatches, energy, cache window) is printed per mode;
   ``python -m repro_torch.analyze --golden --serve --mutate
   --cache-check`` must pass; then a coalesced heal tick is split into
   image build, upload, fused run, MAJX launch and mismatch launches;
7. tmr_ckpt — ``ckpt.tmr_store`` saves a tree on the card (bf16
   4096 x 4096, f32 2048 x 4096, int8 1000 x 333, a nested dict and a
   list) three times, one replica's data is corrupted, and
   ``restore(use_kernel=True)`` must return the clean tree on the card
   with one MAJX launch a leaf; ``scrub`` rewrites the bad replica;
8. sweep — the threefry draws against literal known-answer vectors
   (jax's, recomputed by ``tests/test_torch_rng.py``) on the card and
   the CPU, and 2**23 floats bit-identical on both; the ``Subarray``
   model (MAJ3/5/7/9 at 32-row activation, Multi-RowCopy to 31 rows,
   Frac) over one 8 KiB rank row, bit-identical on the card and the CPU
   with ``ideal=False``, and at 2**18 words on the card, ideal equal to
   the oracle and stochastic within 0.05 of the ErrorModel; a
   stochastic MAJX sweep shaped like Fig. 6 (``sim``, ``cuda``,
   ``oracle``; 64 row images of 2048 words), with a ``sim`` chunk re-run
   on the CPU and a resumed run executing nothing; an MRC sweep shaped
   like Fig. 11; Fig. 7's grid on ``cuda`` and ``oracle`` at 2**18 words
   (one fused MAJX launch a chunk); then ``python -m
   repro_torch.sweep.run --smoke`` (twice, the second
   ``--expect-cached``) and ``--adaptive``, and ``python -m
   repro_torch.analyze --sweep``, in process;
9. sweep_ft — Fig. 7's grid at 2**18 words run by ``run_sweep`` alone,
   then by ``run_sweep_ft`` with three worker threads on the card
   (worker 1 lost on its first chunk, worker 2 stalled past the
   straggler timeout once, so its chunk is re-dispatched) and by
   ``run_sweep`` over a one-card mesh (``majx_batch`` a shard): records
   equal to the single run's, walls and points/s of the three;
10. lm_serve — chatglm3-6b (6.24 B params, bf16) and musicgen-medium
   (1.38 B, 4 codebooks) at full width and depth, zamba2-1.2b (38
   layers, 64-token prompts) and xlstm-125m (12 layers) at full width
   and depth, mixtral-8x22b at 4 of its 56 layers and
   qwen3-moe-235b-a22b at 2 of its 94 (full width), random weights from
   a seed: ``Engine.generate`` serves 8 requests (16 new tokens), each
   prefill and decode step timed beside the step's bytes bound, and
   one decode step profiled for the card's busy share; chatglm3-6b and
   mixtral-8x22b prefill 8,448 tokens on the streaming attention path
   (mixtral's 4,096-token window binding), held to the dense path;
   musicgen-medium's params (about 169k rows of 4096 words) are healed
   from three replicas, one with known flips in six leaves, through a shared ``PudService`` (one
   MAJX and one mismatch launch: bit for bit, ``fixed_bits`` equal to
   the flips, the heal's wall split by step), then verified against the
   clean and the bad replica (exact rates); each model at a cut depth
   (2, 2, 7, 4, 1, 1 layers) is held in float32 against the CPU
   (prefill and teacher-forced decode logits; for the MoE models, the
   tokens routed to other experts than on the CPU are counted) and in
   bfloat16 against float32; MAJX and the mismatch count at the heal's
   shape against their plain versions and bounds;
11. train — musicgen-medium (48 layers, 1.38 B params, bf16, full
   remat) at batch 8 x seq 512 and xlstm-125m (12 layers, the int8
   codec) at batch 4 x seq 128, 8 steps each through ``Trainer.run``
   from a seed: each step's loss (finite, falling), wall and peak
   memory, one more step split into gradients / codec / AdamW and one
   profiled for the card's busy share, beside the step's bound;
   ``launch.train.main`` on the smoke xlstm for 40 steps with a failure
   at step 25 and a 3-replica TMR store (steps 20-24 replayed), then
   the step-40 checkpoint with 64 bytes of one replica flipped,
   restored through the MAJX kernel (one launch a leaf) and the plain
   vote, each bit-equal to a clean replica; each model at 2 / 4 layers
   in float32 on the card against the CPU (``loss_fn`` and every
   gradient leaf), one step at ``microbatches=2`` against 1, and the
   bfloat16 loss against the float32 one;
12. dryrun — ``python -m repro_torch.launch.dryrun`` in one process a
   cell, all at once, on a fake world of 256 ranks (the (16, 16)
   production mesh; one cell on the (2, 16, 16) multi-pod mesh of 512):
   the port's real step laid out as DTensors over ``meta`` tensors, no
   card touched; each cell's per-chip memory, FLOPs, collective bytes
   by kind, bound and roofline fraction; then the dry run's counting on
   a one-device mesh applied to the ``train`` phase's two runs, its
   FLOPs beside ``train_bound``'s 8 N a token and its peak beside the
   peak the card measured in phase 11;
13. paper — ``python -m repro_torch.paper.run`` in process on the card
   (a fresh sweep root, no dry-run file): Figs 3-12 and 15-18, Table 1
   and the five kernel-bench rows, each figure timed; the row names and
   every deterministic value (the analytic figures, Fig 16's speedups,
   Fig 18's dispatches and in-situ DRAM energy) held to the frozen
   :data:`PAPER_ROWS`, which ``tests/test_torch_paper.py`` holds to the
   reference's output; then the five examples' ``main`` on the card
   (``train_tiny_lm`` cut to 12 steps of its small config);
14. the kernels line, then ``{"ok": true, ...}`` as the last line.

Every kernel's launch count is zeroed just before phases 3-13 and read
just after each: the launches must add up to the backend's dispatches
(the store's: one MAJX launch a leaf), and every kernel of the phase's
path must have launched; ``dryrun`` launches none, ``paper`` all five.
Any failed check raises, so the script exits non-zero and prints no
result.  It needs ``torch.cuda.is_available()`` and the repository's
``src/`` and ``tests/golden/`` beside it.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import glob
import io
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
BF16_OPS_PER_S = 989e12    # dense bfloat16 tensor-core peak, same sheet
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


def new_service(**cfg):
    """A ``PudService`` with the user's defaults (the ``cuda`` backend on
    the card, ideal context) or, for a CPU rehearsal, on ``DEVICE``."""
    from repro_torch.backends import ExecutionContext
    from repro_torch.serve import PudService, ServiceConfig

    if DEVICE != "cuda":
        cfg["ctx"] = ExecutionContext(ideal=True, device=DEVICE)
    return PudService(ServiceConfig(**cfg))


SERVE_N = 16             # requests of each kind in one tick
SERVE_ROWS = 8           # rows of a heal / verify tile
SERVE_ERASE_ROWS = 31    # rows of an erase: one wave of fan-out 31
SERVE_PATTERN = 0xDEADBEEF


def serve_mix(rng):
    """The reference serve bench's mix (``benchmarks/serve_bench.py``) at
    the bank width, plus integrity checks: a function making fresh
    requests over the same tiles (requests are stamped at admission), and
    what each must return.  Heal ``i`` flips ``SERVE_N + i`` bits of
    replica ``i % 3`` at positions no other replica flips; check ``i``
    differs from its reference in ``3 * i + 1`` bits."""
    from repro_torch import serve

    n_bits = SERVE_ROWS * WORDS * 32
    heals, verifies = [], []
    for i in range(SERVE_N):
        clean = rng.integers(0, 2**32, (SERVE_ROWS, WORDS), dtype=np.uint32)
        flips = rng.choice(n_bits, SERVE_N + i, replace=False)
        reps = [clean] * 3
        reps[i % 3] = flip_bits(clean, flips)
        heals.append((np.stack(reps), clean,
                      len(flips) if i % 3 == 0 else 0))
        live = rng.integers(0, 2**32, (SERVE_ROWS, WORDS), dtype=np.uint32)
        ref = flip_bits(live, rng.choice(n_bits, 3 * i + 1, replace=False))
        verifies.append((live, ref, 3 * i + 1))

    def make(which=range(SERVE_N)):
        reqs = []
        for i in which:
            reqs.append(serve.HealRequest(replicas=heals[i][0],
                                          tenant=f"heal{i}"))
            reqs.append(serve.EraseRequest(
                rows=SERVE_ERASE_ROWS, words=WORDS, pattern=SERVE_PATTERN,
                fanout=31, tenant=f"erase{i}"))
            reqs.append(serve.IntegrityRequest(
                live=verifies[i][0], reference=verifies[i][1],
                tenant=f"verify{i}"))
        return reqs

    return make, heals, verifies


def check_serve_results(torch, results, heals, verifies, which, what):
    """Every result of one round (``make(which)``'s order) against what
    its tiles must give."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.bitplanes import from_u32

    pattern = int(bp.wrap_i32(torch.tensor(SERVE_PATTERN)))
    for i, (heal, erase, verify) in zip(which, zip(*[iter(results)] * 3)):
        clean = from_u32(heals[i][1], DEVICE)
        check(heal.healed.device == clean.device and torch.equal(
            heal.healed, clean), f"{what}: heal {i} != the clean rows")
        check(heal.fixed_bits == heals[i][2],
              f"{what}: heal {i} fixed {heal.fixed_bits} bits, want "
              f"{heals[i][2]}")
        check(tuple(erase.wiped.shape) == (SERVE_ERASE_ROWS, WORDS) and
              bool((erase.wiped == pattern).all()),
              f"{what}: erase {i} left rows that are not the pattern")
        check(verify.mismatch_bits == verifies[i][2],
              f"{what}: check {i} counted {verify.mismatch_bits} bits, "
              f"want {verifies[i][2]}")


def phase_serve(torch, kernel_mods, timer=None) -> dict:
    """The multi-tenant service on the card: one tick of 16 heals, 16
    erases and 16 integrity checks at 2**18 words a row, coalesced and
    sequential, sync and async; returns each kernel's launches.  With a
    :class:`Timer`, the coalesced heal tick is split afterwards, outside
    the counted window: image build, upload, the fused vote, and the
    mismatch launches."""
    from repro_torch.analyze.__main__ import main as analyze_main

    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    make, heals, verifies = serve_mix(rng)
    emit({"phase": "serve", "mix": {
        "heal": [SERVE_N, 3, SERVE_ROWS, WORDS],
        "erase": [SERVE_N, SERVE_ERASE_ROWS, WORDS, 31],
        "verify": [SERVE_N, SERVE_ROWS, WORDS]},
        "heal_image_mib": 4 * SERVE_N * SERVE_ROWS * WORDS * 4 / 2**20,
        "erase_image_mib": (SERVE_N * SERVE_ERASE_ROWS + 1) * WORDS * 4
        / 2**20, "make_s": time.perf_counter() - t0})

    # Launches a round, as the reference's pallas backend dispatches them.
    want = {True: {"majx": 1, "fanout": 1, "megakernel": 0,
                   "mismatch": 2 * SERVE_N, "bitserial": 0},
            False: {"majx": SERVE_N, "fanout": SERVE_N, "megakernel": 0,
                    "mismatch": 2 * SERVE_N, "bitserial": 0}}
    zero_launches(kernel_mods)
    dispatches = 0
    results = {}
    for coalesce in (True, False):
        mode = "coalesced" if coalesce else "sequential"
        svc = new_service(pool_size=2, max_batch=3 * SERVE_N,
                          queue_depth=12 * SERVE_N, tick_window_s=0.0,
                          coalesce=coalesce)
        kinds, walls = [], []   # each batch's kind and wall
        execute, record = svc.batcher.execute, svc.slo.record_batch

        def execute_kind(plan, session, _execute=execute):
            kinds.append(plan.kind)
            return _execute(plan, session)

        def record_batch(n, wall, *args, _record=record, **kw):
            walls.append(wall)
            return _record(n, wall, *args, **kw)

        svc.batcher.execute = execute_kind
        svc.slo.record_batch = record_batch
        t0 = time.perf_counter()
        warm = svc.serve(make())
        warm_s = time.perf_counter() - t0
        check_serve_results(torch, warm, heals, verifies, range(SERVE_N),
                            f"{mode}/warm-up")
        check(svc.cache.stats.misses == 2, f"{mode}: warm-up compiled "
              f"{svc.cache.stats.misses} tick shapes, want 2")
        svc.reset_slo()
        del kinds[:], walls[:]
        rounds = []
        for r in range(2):
            before = {n: m.launches for n, m in kernel_mods.items()}
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                scopes = [stack.enter_context(s.count_dispatches())
                          for s in svc.sessions]
                out = svc.serve(make())
            rounds.append(time.perf_counter() - t0)
            launched = {n: m.launches - before[n]
                        for n, m in kernel_mods.items()}
            n_disp = sum(sc.count for sc in scopes)
            check(n_disp == sum(want[coalesce].values()),
                  f"{mode}: round {r} dispatched {n_disp}")
            check(DEVICE != "cuda" or launched == want[coalesce],
                  f"{mode}: round {r} launched {launched}, want "
                  f"{want[coalesce]}")
            check_serve_results(torch, out, heals, verifies, range(SERVE_N),
                                f"{mode}/round {r}")
            results.setdefault(mode, out)
        snap = svc.snapshot()
        check(snap.completed == 2 * 3 * SERVE_N and snap.shed == 0
              and snap.rejected == 0, f"{mode}: snapshot {snap}")
        check(snap.cache["misses"] == 0 and snap.cache["hits"] > 0,
              f"{mode}: after reset_slo the cache window is "
              f"{snap.cache}, want hits only")
        tick_s = {}
        for kind, wall in zip(kinds, walls):
            tick_s[kind] = tick_s.get(kind, 0.0) + wall / len(rounds)
        emit({"phase": "serve", "mode": mode,
              "throughput_rps": snap.throughput_rps,
              "p50_ms": snap.p50_latency_s * 1e3,
              "p99_ms": snap.p99_latency_s * 1e3,
              "batches": snap.batches,
              "occupancy": snap.batch_occupancy,
              "dispatches": snap.dispatches,
              "dispatches_per_round": snap.dispatches // 2,
              "energy_nj_per_request": snap.energy_nj / snap.completed,
              "cache": snap.cache, "round_s": rounds,
              "warmup_s": warm_s, "batch_wall_s_per_round": tick_s,
              "slow_sessions": snap.slow_sessions})
        dispatches += sum(s.dispatch_count for s in svc.sessions)

    for a, b in zip(results["coalesced"], results["sequential"]):
        for field in ("healed", "wiped"):
            if hasattr(a, field):
                check(torch.equal(getattr(a, field), getattr(b, field)),
                      f"coalesced and sequential {field} differ")

    # Async: start, six submissions gathered, stop.
    svc = new_service(pool_size=2, max_batch=3 * SERVE_N,
                      queue_depth=12 * SERVE_N)

    async def client(reqs):
        await svc.start()
        out = await asyncio.gather(*(svc.submit(r) for r in reqs))
        await svc.stop()
        return out

    which = (0, 5)
    t0 = time.perf_counter()
    out = asyncio.run(client(make(which)))
    check_serve_results(torch, out, heals, verifies, which, "async")
    check(svc.backlog == 0 and svc.snapshot().completed == 6,
          "async: the loop did not drain")
    dispatches += sum(s.dispatch_count for s in svc.sessions)
    emit({"phase": "serve", "mode": "async", "requests": 6,
          "wall_s": time.perf_counter() - t0,
          "batches": svc.snapshot().batches})
    launches = read_launches(kernel_mods, ("majx", "fanout", "mismatch"),
                             dispatches, "serve")

    # The analyzer's CLI on the serve tick programs (and the goldens,
    # the mutation gate and the cache check), from the repository root.
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = analyze_main(["--golden", "--serve", "--mutate",
                               "--cache-check", "--device", DEVICE])
    finally:
        os.chdir(cwd)
    lines = buf.getvalue().splitlines()
    check(rc == 0 and any(ln.startswith("OK   serve/tick") for ln in lines),
          "python -m repro_torch.analyze failed:\n" + "\n".join(lines))
    emit({"phase": "serve", "analyze_rc": rc,
          "analyze": [ln for ln in lines if "serve/" in ln or
                      "analyze:" in ln]})
    if timer is not None:
        serve_split(torch, timer, make, kernel_mods)
        serve_profile(torch, make)
    return launches


def serve_profile(torch, make) -> None:
    """The card's busy share in one coalesced round, from a
    ``torch.profiler`` trace: the device time of every kernel and copy
    (one stream: they do not overlap) over the round's wall, which the
    profiler itself lengthens.  Printed as not measured (null) when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    svc = new_service(pool_size=2, max_batch=3 * SERVE_N,
                      queue_depth=12 * SERVE_N)
    svc.serve(make())                     # warm-up: compile, certify
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.serve(make())
        _sync(torch)
        wall = time.perf_counter() - t0
    device_us = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        device_us[e.key[:80]] = (us, e.count)
    busy = sum(us for us, _ in device_us.values()) / 1e6
    htod = sum(us for k, (us, _) in device_us.items()
               if k.startswith("Memcpy HtoD")) / 1e6
    # The images and tiles a round uploads: the heal and erase images,
    # and both tiles of every check.
    n_bytes = (4 * SERVE_N * SERVE_ROWS + SERVE_N * SERVE_ERASE_ROWS + 1
               + 2 * SERVE_N * SERVE_ROWS) * WORDS * 4
    top = sorted(device_us.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "serve", "profile": "one coalesced round",
          "wall_s": wall, "device_busy_s": busy if busy else None,
          "device_busy_share": busy / wall if busy else None,
          "device_not_upload_s": busy - htod if busy else None,
          "upload_bytes": n_bytes,
          "upload_gb_per_s": n_bytes / htod / 1e9 if htod else None,
          "top_device_us": {k: {"us": us, "count": n}
                            for k, (us, n) in top}})


def serve_split(torch, timer, make, kernel_mods) -> None:
    """Where a coalesced heal tick's wall goes, each part alone: building
    the program and its numpy image on the host, uploading the image,
    the fused run (gather, one MAJX launch, scatter), the MAJX launch by
    itself, and the mismatch launches (one a heal, each read back)."""
    from repro_torch.core import calibration as cal
    from repro_torch.core.bitplanes import from_u32
    from repro_torch.kernels.majx import ops as majx_ops

    reqs = [r for r in make() if r.kind == "heal"]
    sess = new_session("smoke/serve-split")
    x, total = 3, SERVE_N * SERVE_ROWS
    build_s = {}
    t0 = time.perf_counter()
    tiles = [np.concatenate([r.replicas[j] for r in reqs])
             for j in range(x)]
    t1 = time.perf_counter()
    build_s["concatenate"] = t1 - t0
    b = sess.program(rows=(x + 1) * total, name="serve/heal-x3")
    groups = [b.input(t) for t in tiles]
    out = b.alloc_rows(total)
    for r in range(total):
        b.maj(*(g[r] for g in groups), dst=out[r],
              n_act=cal.min_activation_for(32))
    prog = b.build()
    t0 = time.perf_counter()
    build_s["program"] = t0 - t1
    state = b.initial_state()
    build_s["initial_state"] = time.perf_counter() - t0
    del tiles
    uploads = []
    for _ in range(3):
        _sync(torch)
        t0 = time.perf_counter()
        image = from_u32(state, DEVICE)
        _sync(torch)
        uploads.append(time.perf_counter() - t0)
    del state
    sess.run_fused(prog, image)     # first run: schedule, certificate
    runs = []
    for _ in range(3):
        _sync(torch)
        t0 = time.perf_counter()
        final = sess.run_fused(prog, image)
        _sync(torch)
        runs.append(time.perf_counter() - t0)
    planes = image[:x * total].reshape(x, total, WORDS)
    vote_ms = timer(lambda: majx_ops.majx(planes), reps=5, warmup=1)
    voted = final[x * total:]
    rep0 = image[:total]
    mism = []
    for _ in range(3):
        _sync(torch)
        t0 = time.perf_counter()
        for i in range(SERVE_N):
            lo = i * SERVE_ROWS
            int(sess.mismatch(rep0[lo:lo + SERVE_ROWS],
                              voted[lo:lo + SERVE_ROWS]))
        mism.append(time.perf_counter() - t0)
    one = rep0[:SERVE_ROWS].contiguous()
    mismatch_ms = timer(lambda: sess.mismatch(one, voted[:SERVE_ROWS]),
                        reps=5, warmup=1)
    emit({"phase": "serve", "split": "coalesced heal tick",
          "image_mib": image.numel() * 4 / 2**20,
          "build_s": build_s, "upload_s": min(uploads),
          "upload_gb_per_s": image.numel() * 4 / min(uploads) / 1e9,
          "fused_run_s": min(runs), "majx_ms": vote_ms,
          "majx_bound_ms": bound((x + 1) * total * WORDS * 4,
                                 total * WORDS * vote_ops(x))[0],
          "mismatch_all_s": min(mism), "mismatch_one_ms": mismatch_ms,
          "mismatch_launches": SERVE_N})
    del image, final, planes


def phase_tmr_ckpt(torch, kernel_mods) -> dict:
    """The TMR checkpoint store on the card: save a tree of tensors three
    times, corrupt one replica's data, restore voted through the MAJX
    kernel (one launch a leaf), scrub; returns each kernel's launches."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.ckpt import tmr_store
    from repro_torch.core import tree as tree_util

    g = torch.Generator(device=DEVICE).manual_seed(5)
    tree = {"w": torch.randn(4096, 4096, generator=g, device=DEVICE)
            .to(torch.bfloat16),
            "proj": torch.randn(2048, 4096, generator=g, device=DEVICE),
            "emb": torch.randint(-128, 128, (1000, 333), generator=g,
                                 device=DEVICE, dtype=torch.int8),
            "opt": {"step": torch.arange(17, device=DEVICE,
                                         dtype=torch.int32),
                    "moments": [torch.randn(4096, generator=g,
                                            device=DEVICE),
                                torch.randn(3, 5, generator=g,
                                            device=DEVICE)
                                .to(torch.float16)]}}
    leaves, _ = tree_util.flatten(tree)
    names = [n for n, _ in tree_util.flatten_with_path(tree)[0]]

    def same(got) -> bool:
        return all(a.device == b.device and a.dtype == b.dtype and
                   torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(tree_util.flatten(got)[0], leaves))

    zero_launches(kernel_mods)
    secs = {}
    with tempfile.TemporaryDirectory(prefix="tmr_ckpt") as d:
        t0 = time.perf_counter()
        tmr_store.save(tree, d, 7, replicas=3)
        secs["save"] = time.perf_counter() - t0
        # Flip bytes in three leaves of replica 1 and write its shard
        # back: the archive stays readable, the manifest's crc32 fails.
        shard = os.path.join(d, "replica_1", "step_00000007",
                             "shard_p0.npz")
        with np.load(shard) as data:
            arrays = {k: data[k] for k in data.files}
        with open(os.path.join(os.path.dirname(shard),
                               "manifest.json")) as f:
            keys = {leaf["name"]: leaf["key"]
                    for leaf in json.load(f)["leaves"]}
        frng = np.random.default_rng(7)
        for name in ("['w']", "['proj']", "['emb']"):
            raw = arrays[keys[name]].view(np.uint8).reshape(-1)
            raw[frng.choice(raw.size, 4096, replace=False)] ^= 0xA5
        np.savez(shard, **arrays)
        try:
            ckpt.restore(tree, os.path.join(d, "replica_1"))
        except IOError as err:
            check("crc mismatch" in str(err), f"corruption: {err}")
        else:
            raise AssertionError("the corrupted replica restored verified")
        before = kernel_mods["majx"].launches
        t0 = time.perf_counter()
        got, step, bad = tmr_store.restore(tree, d, use_kernel=True)
        _sync(torch)
        secs["restore_kernel"] = time.perf_counter() - t0
        majx = kernel_mods["majx"].launches - before
        check((step, bad) == (7, 1), f"restore: step {step}, {bad} bad")
        want = len(leaves) if DEVICE == "cuda" else 0
        check(majx == want, f"restore launched MAJX {majx} times for "
              f"{len(leaves)} leaves")
        check(same(got), "restore(use_kernel=True) != the clean tree")
        t0 = time.perf_counter()
        plain, _, _ = tmr_store.restore(tree, d)
        _sync(torch)
        secs["restore_plain"] = time.perf_counter() - t0
        check(same(plain), "restore() != the clean tree")
        t0 = time.perf_counter()
        check(tmr_store.scrub(tree, d) == 1, "scrub: want 1 healed")
        secs["scrub"] = time.perf_counter() - t0
        for r in range(3):
            again, _ = ckpt.restore(tree, os.path.join(d, f"replica_{r}"),
                                    verify=True)
            check(same(again), f"replica {r} after scrub != the clean tree")
        check(tmr_store.scrub(tree, d) == 0, "scrub: nothing left to heal")
    emit({"phase": "tmr_ckpt", "leaves": names,
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "replicas": 3, "bad": bad, "majx_launches": majx,
          "host_s": secs})
    return read_launches(kernel_mods, ("majx",), len(leaves), "tmr_ckpt")


# ------------------------------------------------------------ sweep
#: Known-answer vectors of jax 0.9.0's draws (threefry2x32, partitionable
#: counters, 64-bit types disabled): each case and its uint32 words,
#: float32 draws as their bit patterns, bools as 0/1.
#: ``tests/test_torch_rng.py`` recomputes every one with jax; the card's
#: machine has no JAX, so they are literals here.
RNG_VECTORS = [
    (("key", 0), [0, 0]),
    (("key", 20261017), [0, 20261017]),
    (("key", -3), [0, 4294967293]),
    (("split", 7, 3), [3625411723, 1954958720, 195045567, 4062205631,
                       966301609, 1948237315]),
    (("fold_in", 7, 2147483647), [2754890656, 2861703899]),
    (("fold_in", 1009, 5), [3225684408, 1181187759]),
    (("bits", 7, (2, 5)), [2895194379, 4185947648, 1300703658, 1906787632,
                           3139134342, 2709822315, 1926509400, 1767298410,
                           299634315, 385396910]),
    (("bits", 0, ()), [4070199207]),
    (("uniform", 7, (8,), 0.0, 1.0), [1059885352, 1064927358, 1050349136,
                                      1055084168, 1060838242, 1059161242,
                                      1055238244, 1053994408]),
    (("uniform", 3, (6,), -0.4, 0.4), [3199104979, 1051948739, 1039404314,
                                       1052954746, 3191180685, 1032315584]),
    (("bernoulli", 7, 0.3, (16,)), [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0,
                                    1, 0, 0]),
]
SWEEP_ROWS = 64          # row images a point in the Fig. 6-shaped sweep


def rng_case(rng, case, device):
    """One known-answer case drawn by the port on ``device``, as int32
    words on the CPU (keys derive on the host whatever the device)."""
    import torch

    kind, seed, *args = case
    key = rng.PRNGKey(seed)
    if kind == "key":
        out = key
    elif kind == "split":
        out = rng.split(key, args[0])
    elif kind == "fold_in":
        out = rng.fold_in(key, args[0])
    elif kind == "bits":
        out = rng.random_bits(key, args[0], device)
    elif kind == "uniform":
        out = rng.uniform(key, args[0], args[1], args[2], device).view(
            torch.int32)
    else:
        out = rng.bernoulli(key, args[0], args[1], device).to(torch.int32)
    return out.cpu()


def device_model_ops(torch, sa, seed: int):
    """A random fill, then MAJ3/5/7/9 at 32-row activation, a
    Multi-RowCopy to 31 rows and Frac of 4 rows on one subarray; returns
    the results (four MAJX planes, then the 31 copies) on the
    subarray's device, the operands written (four stacks, then the
    source row) and the wall of each step, the device synchronized
    around it (its host draws of the operands included)."""
    from repro_torch.core import majx as mj
    from repro_torch.core import rowcopy as rc

    rng = np.random.default_rng(seed)
    walls = {}

    def step(name, fn):
        _sync(torch)
        t0 = time.perf_counter()
        out = fn()
        _sync(torch)
        walls[name] = time.perf_counter() - t0
        return out

    step("fill", lambda: sa.fill("random"))
    out, ops = [], []
    for i, x in enumerate((3, 5, 7, 9)):
        operands = rng.integers(0, 2**32, (x, sa.n_words), dtype=np.uint32)
        ops.append(operands)
        out.append(step(f"maj{x}", lambda: mj.majx(
            sa, list(operands), 32, base_row=32 * i)))
    src = rng.integers(0, 2**32, sa.n_words, dtype=np.uint32)
    ops.append(src)
    _, dests = step("mrc31", lambda: rc.multi_rowcopy(sa, src, 32,
                                                      base_row=128))
    out.append(sa.planes[torch.tensor(dests, device=sa.device)])
    step("frac4", lambda: rc.frac_init(sa, range(200, 204)))
    return out, ops, walls


def count_calls(cls, name: str, tally: list):
    """Wrap ``cls.name`` so that each call appends to ``tally``; returns
    the undo.  The script counts the backend's dispatches and fused runs
    so; what they do is unchanged."""
    orig = getattr(cls, name)

    def wrapped(self, *a, **kw):
        tally.append(1)
        return orig(self, *a, **kw)

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def same_but_backend(a: dict, b: dict) -> bool:
    return ({k: v for k, v in a.items() if k not in ("index", "backend")}
            == {k: v for k, v in b.items() if k not in ("index", "backend")})


def sweep_rng(torch) -> None:
    """The literal vectors on the card and on the CPU, then one draw of
    2**23 floats on both, bit-identical."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.core import rng

    for case, words in RNG_VECTORS:
        for dev in (DEVICE, "cpu"):
            got = bp.to_u32(rng_case(rng, case, dev)).reshape(-1).tolist()
            check(got == words, f"rng {case} on {dev}: {got} != {words}")
    key = rng.fold_in(rng.PRNGKey(20261017), 0x5EED)
    _sync(torch)
    t0 = time.perf_counter()
    big = rng.uniform(key, (2**23,), device=DEVICE)
    _sync(torch)
    draw_s = time.perf_counter() - t0
    host = rng.uniform(key, (2**23,), device="cpu")
    check(torch.equal(big.cpu().view(torch.int32), host.view(torch.int32)),
          "rng: 2**23 floats differ between the card and the CPU")
    emit({"phase": "sweep", "rng_vectors": len(RNG_VECTORS),
          "uniform_2e23_s": draw_s})


def sweep_device_model(torch) -> None:
    """The Subarray model: one 8 KiB rank row on the card and the CPU,
    bit-identical with ``ideal=False``; then the bank width on the card,
    ``ideal=True`` against the oracle and stochastic within 0.05 of the
    ErrorModel's success; the wall per op."""
    from repro_torch.backends import ExecutionContext, get_backend
    from repro_torch.core import calibration as cal
    from repro_torch.core.errormodel import ErrorModel
    from repro_torch.core.subarray import DeviceProfile, Subarray

    def subarray(words, device, ideal):
        return Subarray(DeviceProfile.mfr_h(), cols=words * 32, seed=11,
                        ideal=ideal, device=device)

    card, host = (subarray(RANK_WORDS, d, False) for d in (DEVICE, "cpu"))
    got, _, rank_walls = device_model_ops(torch, card, 1)
    want, _, _ = device_model_ops(torch, host, 1)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
          and torch.equal(card.planes.cpu(), host.planes)
          and (card.frac_rows == host.frac_rows).all(),
          "device model: the card's planes differ from the CPU's")
    oracle = get_backend("oracle", ExecutionContext(device=DEVICE))
    em = ErrorModel("H")
    walls, measured = {}, {}
    for ideal in (True, False):
        tag = "ideal" if ideal else "stochastic"
        sa = subarray(WORDS, DEVICE, ideal)
        outs, ops, walls[tag] = device_model_ops(torch, sa, 2)
        wants = [oracle.majx(o) for o in ops[:4]]
        wants.append(oracle.rowcopy(ops[4], 31))
        expects = [em.majx_success(x, 32, t1=cal.MAJX_BEST_T1_NS,
                                   t2=cal.MAJX_BEST_T2_NS)
                   for x in (3, 5, 7, 9)]
        expects.append(em.mrc_success(31, t1=cal.MRC_BEST_T1_NS,
                                      t2=cal.MRC_BEST_T2_NS))
        for name, res, w, e in zip(("maj3", "maj5", "maj7", "maj9",
                                    "mrc31"), outs, wants, expects):
            rate = 1.0 - int(oracle.mismatch(res, w)) / (res.numel() * 32)
            measured[f"{name}_{tag}"] = [rate, 1.0 if ideal else e]
            check(rate == 1.0 if ideal else abs(rate - e) <= 0.05,
                  f"device model {name} {tag}: success {rate} against "
                  f"{1.0 if ideal else e}")
        check(sa.frac_rows[200:204].all(), "Frac left rows unmarked")
        del sa
    emit({"phase": "sweep", "device_model": {
        "rank_words": RANK_WORDS, "bank_words": WORDS,
        "rank_row_wall_s": rank_walls, "bank_wall_s": walls,
        "success": measured}})


def sweep_spice(torch) -> None:
    """The §7.2 Monte-Carlo study (``chargeshare.spice_study``, 10**4
    iterations a cell of its N x PV grid) on the card and on the CPU:
    every deviation bit-identical and every success count equal; the
    32- over 4-row deviation gain and the 0 -> 40 % PV success drops
    beside the paper's."""
    import math

    from repro_torch.core import calibration as cal
    from repro_torch.core import chargeshare as cs
    from repro_torch.core import rng

    key = rng.PRNGKey(0)
    cs.spice_study(key, 16, device=DEVICE)                  # warm-up
    _sync(torch)
    t0 = time.perf_counter()
    card = cs.spice_study(key, device=DEVICE)
    _sync(torch)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = cs.spice_study(key, device="cpu")
    host_s = time.perf_counter() - t0
    check(card.keys() == host.keys() and len(card) == 25,
          f"spice: cells {sorted(card)}")
    for k, want in host.items():
        got = card[k]
        check(all(math.isfinite(v) for v in got.values())
              and got == want,
              f"spice {k}: card {got} != CPU {want}")
    gain = card[(32, 0.0)]["dev_mean"] / card[(4, 0.0)]["dev_mean"] - 1.0
    drops = {n: 1.0 - card[(n, 0.4)]["success_rate"]
             / card[(n, 0.0)]["success_rate"] for n in (4, 32)}
    check(abs(gain - cal.SPICE_DEVIATION_GAIN_32_OVER_4_REL) < 0.01,
          f"spice: 32/4-row deviation gain {gain}")
    emit({"phase": "sweep", "spice": {
        "iters": cal.SPICE_MC_ITERS, "cells": len(card), "card_s": card_s,
        "cpu_s": host_s, "dev_gain_32_over_4": gain,
        "paper_gain": cal.SPICE_DEVIATION_GAIN_32_OVER_4_REL,
        "pv40_drop": {"4": drops[4], "32": drops[32]},
        "paper_drop": {"4": cal.SPICE_MAJ3_4ROW_PV_DROP_REL,
                       "32": cal.SPICE_MAJ3_32ROW_PV_DROP_REL}}})


SWEEP_RANGES = ("sweep.draws", "sweep.upload", "sweep.fused_run",
                "sweep.oracle", "sweep.counts")


def sweep_profile(torch, fig6, fig7) -> None:
    """Where a sweep chunk's wall goes, outside the counted window: the
    card's busy share in one ``sim`` chunk of ``fig6`` and one ``cuda``
    chunk of ``fig7`` from ``torch.profiler`` traces (the profiler
    lengthens the walls), and the ``cuda`` chunk split by the ranges
    ``_Executor._majx_batched`` marks: host time (inclusive) and the
    device time of the kernels launched inside each range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sweep import planner
    from repro_torch.sweep import runner as sr

    def device_us(e, kind):
        name = f"{kind}device_time_total"
        return getattr(e, name if hasattr(e, name)
                       else f"{kind}cuda_time_total", 0)

    out = {}
    for tag, spec, backend in (("sim_chunk", fig6, "sim"),
                               ("cuda_chunk", fig7, "cuda")):
        chunk = [c for c in planner.plan(spec) if c.backend == backend][-1]
        sr._Executor(spec, device=DEVICE).execute(chunk)     # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sr._Executor(spec, device=DEVICE).execute(chunk)
            _sync(torch)
            wall = time.perf_counter() - t0
        busy_us, kernels = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.key in SWEEP_RANGES:
                continue
            busy_us += device_us(e, "self_")
            kernels += e.count
        out[tag] = {"points": len(chunk.points), "rows": spec.rows,
                    "words": spec.words, "wall_s": wall,
                    "device_busy_s": busy_us / 1e6 if busy_us else None,
                    "device_busy_share": busy_us / 1e6 / wall
                    if busy_us else None, "device_ops": kernels}
        if backend == "cuda":
            split = {r: {"host_s": 0.0, "device_s": 0.0}
                     for r in SWEEP_RANGES}
            for e in prof.events():
                if e.name in split and e.device_type == DeviceType.CPU:
                    split[e.name]["host_s"] += e.cpu_time_total / 1e6
                    split[e.name]["device_s"] += device_us(e, "") / 1e6
            check(all(v["host_s"] > 0 for v in split.values()),
                  f"profile: a range of the cuda chunk is missing: {split}")
            out[tag]["split"] = split
            out[tag]["batch_mib"] = sum(
                p.x * spec.rows * spec.words * 4
                for p in chunk.points) / 2**20
    emit({"phase": "sweep", "profile": out})


def phase_sweep(torch, kernel_mods) -> dict:
    """The sweep phase, its record stores in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as root:
        return sweep_in(torch, kernel_mods, root)


def sweep_in(torch, kernel_mods, root: str) -> dict:
    """The behavioural device model and the characterization sweep on
    the card: the threefry draws against literal vectors, the Subarray
    model at two widths, the §7.2 Monte-Carlo study, a stochastic MAJX
    sweep shaped like Fig. 6, an MRC sweep shaped like Fig. 11 and the
    ``cuda`` batched path at the bank width (Fig. 7's grid), then the
    sweep CLI and the analyzer's ``--sweep``; returns each kernel's
    launches over the three sweeps."""
    from repro_torch.analyze.__main__ import main as analyze_main
    from repro_torch.backends.cuda import CudaBackend
    from repro_torch.sweep import SweepSpec, aggregate, planner, run_sweep
    from repro_torch.sweep import runner as sweep_runner
    from repro_torch.sweep.run import main as sweep_main

    sweep_rng(torch)
    sweep_device_model(torch)
    sweep_spice(torch)

    dispatches, fused, chunk_walls = [], [], []
    undo = [count_calls(CudaBackend, "_launch", dispatches),
            count_calls(CudaBackend, "run_fused", fused)]
    orig_execute = sweep_runner._Executor.execute

    def timed_execute(self, chunk):
        _sync(torch)
        t0 = time.perf_counter()
        out = orig_execute(self, chunk)
        _sync(torch)
        chunk_walls.append([chunk.backend, len(chunk.points),
                            time.perf_counter() - t0])
        return out

    sweep_runner._Executor.execute = timed_execute
    undo.append(lambda: setattr(sweep_runner._Executor, "execute",
                                orig_execute))
    report = {}
    fig6 = SweepSpec(name="chip-fig6", op="majx",
                     backends=("sim", "cuda", "oracle"),
                     x_values=(3, 5, 7, 9), n_act=(4, 8, 16, 32),
                     patterns=("random",), rows=SWEEP_ROWS,
                     words=RANK_WORDS, ideal=False, seeds=(0,))
    fig11 = SweepSpec(name="chip-fig11", op="mrc", backends=("sim", "cuda"),
                      n_act=(2, 4, 8, 16, 32),
                      patterns=("0x00", "0xFF", "random"), words=RANK_WORDS)
    fig7 = fig7_bank_spec("chip-fig7-bank")
    try:
        zero_launches(kernel_mods)
        # 3. A stochastic MAJX sweep shaped like Fig. 6.
        t0 = time.perf_counter()
        res = run_sweep(fig6, root, device=DEVICE)
        fig6_s = time.perf_counter() - t0
        by = {}
        for r in res.records:
            by.setdefault(r["backend"], {})[(r["x"], r["n_act"])] = r
        check(len(res.records) == fig6.n_points() == 36,
              f"fig6: {len(res.records)} records")
        for k, r in by["cuda"].items():
            check(same_but_backend(r, by["oracle"][k])
                  and r["success"] == 1.0, f"fig6: cuda {r} != oracle")
        for r in by["sim"].values():
            check(abs(r["success"] - r["expected"]) <= 0.05,
                  f"fig6: sim {r['x']}@{r['n_act']} success "
                  f"{r['success']} against {r['expected']}")
        delta = aggregate.replication_delta(res.records, backend="sim")
        check(delta > 0.15, f"fig6: replication delta {delta}")
        sim_chunk = [c for c in planner.plan(fig6) if c.backend == "sim"][-1]
        stored = [r for r in res.records if r["index"] in sim_chunk.indices]
        t1 = time.perf_counter()
        again = orig_execute(sweep_runner._Executor(fig6, device="cpu"),
                             sim_chunk)
        cpu_chunk_s = time.perf_counter() - t1
        check(again == stored, "fig6: a sim chunk re-run on the CPU differs")
        resumed = run_sweep(fig6, root, device=DEVICE)
        check(resumed.executed_chunks == 0
              and resumed.records == res.records,
              f"fig6 resume: {resumed.summary()}")
        report["fig6"] = {
            "points": fig6.n_points(), "wall_s": fig6_s,
            "replication_delta": delta, "paper": 0.3081,
            "sim_success_expected": {
                f"{x}@{n}": [r["success"], r["expected"]]
                for (x, n), r in sorted(by["sim"].items())},
            "sim_chunk_points": len(sim_chunk.points),
            "sim_chunk_cpu_s": cpu_chunk_s}

        # 4. An MRC sweep shaped like Fig. 11.
        t0 = time.perf_counter()
        res = run_sweep(fig11, root, device=DEVICE)
        fig11_s = time.perf_counter() - t0
        for r in res.records:
            check(r["success"] == 1.0 if r["backend"] == "cuda"
                  else abs(r["success"] - r["expected"]) <= 0.05,
                  f"fig11: {r}")
        report["fig11"] = {
            "points": fig11.n_points(), "wall_s": fig11_s,
            "sim_success_expected": {
                f"{r['n_dest']}/{r['pattern']}": [r["success"],
                                                  r["expected"]]
                for r in res.records if r["backend"] == "sim"}}

        # 5. The cuda batched path at the bank width: Fig. 7's grid (the
        # five §3.1 MAJX patterns, so each arity's chunk holds 5 points).
        first = len(chunk_walls)
        t0 = time.perf_counter()
        res = run_sweep(fig7, root, device=DEVICE)
        fig7_s = time.perf_counter() - t0
        by = {}
        for r in res.records:
            by.setdefault(r["backend"], {})[(r["x"], r["pattern"])] = r
        for k, r in by["cuda"].items():
            check(same_but_backend(r, by["oracle"][k])
                  and r["success"] == 1.0, f"fig7: cuda {r} != oracle")
        walls = {b: [w for b2, _, w in chunk_walls[first:] if b2 == b]
                 for b in ("cuda", "oracle")}
        report["fig7_bank"] = {
            "points": fig7.n_points(), "wall_s": fig7_s,
            "words": WORDS, "cuda_wall_s_per_chunk": walls["cuda"],
            "cuda_points_per_s": len(by["cuda"]) / sum(walls["cuda"]),
            "oracle_wall_s_per_chunk": walls["oracle"]}
    finally:
        for u in undo:
            u()
    want_fused = sum(1 for spec in (fig6, fig7) for c in planner.plan(spec)
                     if c.backend == "cuda" and len(c.points) > 1)
    check(kernel_mods["majx"].launches == len(fused) == want_fused,
          f"sweep: MAJX launches {kernel_mods['majx'].launches}, fused "
          f"runs {len(fused)}, fused chunks {want_fused}")
    report["fused_chunks"] = want_fused
    report["chunk_walls"] = chunk_walls
    emit({"phase": "sweep", **report})
    launches = read_launches(kernel_mods, ("majx", "fanout", "mismatch"),
                             len(dispatches), "sweep")
    if DEVICE == "cuda":
        sweep_profile(torch, fig6, fig7)

    # 6. The CLI: --smoke twice (the second fully cached), --adaptive,
    # and the analyzer's --sweep subject.
    cwd = os.getcwd()
    os.chdir(ROOT)
    outs = {}
    try:
        for name, main_fn, argv in (
                ("smoke", sweep_main, ["--smoke", "--root", root, "--quiet",
                                       "--device", DEVICE]),
                ("smoke_cached", sweep_main,
                 ["--smoke", "--root", root, "--quiet", "--device", DEVICE,
                  "--expect-cached"]),
                ("adaptive", sweep_main, ["--adaptive", "--root", root,
                                          "--quiet", "--device", DEVICE]),
                ("analyze_sweep", analyze_main, ["--sweep"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main_fn(argv)
            lines = buf.getvalue().splitlines()
            check(rc == 0, f"{name}: rc {rc}\n" + "\n".join(lines))
            outs[name] = {"s": time.perf_counter() - t0, "lines": lines}
    finally:
        os.chdir(cwd)
    check(" 0 chunks executed" in outs["smoke_cached"]["lines"][0],
          f"--expect-cached: {outs['smoke_cached']['lines']}")
    check(any(ln.startswith("OK   sweep/smoke/chunk-")
              for ln in outs["analyze_sweep"]["lines"]),
          f"analyze --sweep: {outs['analyze_sweep']['lines']}")
    emit({"phase": "sweep", "cli": outs})
    return launches



# ------------------------------------------------------------ sweep_ft
#: Worker threads of the fault-tolerant sweep, and the straggler's stall:
#: worker 2 sleeps FT_STALL_S once, past FT_TIMEOUT_S, so its chunk is
#: re-dispatched to a healthy worker.
FT_WORKERS = 3
FT_STALL_S = 4.0
FT_TIMEOUT_S = 0.5


def fig7_bank_spec(name: str):
    """Fig. 7's grid on ``cuda`` and ``oracle`` at the bank width: the
    five §3.1 MAJX patterns, so each arity's chunk holds 5 points."""
    from repro_torch.core import calibration as cal
    from repro_torch.sweep import SweepSpec

    return SweepSpec(name=name, op="majx", backends=("cuda", "oracle"),
                     x_values=(3, 5, 7, 9), n_act=(32,),
                     patterns=cal.DATA_PATTERNS, ideal=True, rows=2,
                     words=WORDS, chunk=8)


def phase_sweep_ft(torch, kernel_mods) -> dict:
    """The fault-tolerant and mesh-placed sweep, its stores in a
    temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_ft_") as root:
        return sweep_ft_in(torch, kernel_mods, root)


def sweep_ft_in(torch, kernel_mods, root: str) -> dict:
    """Fig. 7's grid at 2**18 words: ``run_sweep`` alone, then the path
    — ``run_sweep_ft`` with FT_WORKERS threads on the card (worker 1
    lost on its first chunk, worker 2 a straggler once) and ``run_sweep``
    over a one-card mesh (``majx_batch`` a shard) — each held to the
    single-worker records; returns each kernel's launches over the
    path."""
    import threading

    from repro_torch.backends.cuda import CudaBackend
    from repro_torch.ft.failures import WorkerLost
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sweep import planner, run_sweep, run_sweep_ft

    spec = fig7_bank_spec("chip-fig7-ft")
    n_cuda = spec.n_points() // 2

    def timed(fn, *args, **kw):
        _sync(torch)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(torch)
        return out, time.perf_counter() - t0

    def by_index(records):
        return sorted(records, key=lambda r: r["index"])

    base, base_s = timed(run_sweep, spec, os.path.join(root, "single"),
                         device=DEVICE)
    want = by_index(base.records)
    check(len(want) == spec.n_points(), f"sweep_ft: {len(want)} records")

    first = threading.Barrier(FT_WORKERS, timeout=60)
    lock = threading.Lock()
    seen, events = set(), []

    def hook(wid, chunk):
        with lock:
            is_first = wid not in seen
            seen.add(wid)
        if is_first:
            first.wait()      # every worker holds a chunk before a fault
            if wid == 1:
                events.append(("lost", wid, chunk.key))
                raise WorkerLost("injected on its first chunk")
            if wid == 2:
                events.append(("stall", wid, chunk.key))
                time.sleep(FT_STALL_S)

    dispatches, majx_batches = [], []
    undo = [count_calls(CudaBackend, "_launch", dispatches),
            count_calls(CudaBackend, "majx_batch", majx_batches)]
    try:
        zero_launches(kernel_mods)
        ft, ft_s = timed(run_sweep_ft, spec, os.path.join(root, "ft"),
                         n_workers=FT_WORKERS, worker_hook=hook,
                         straggler_timeout_s=FT_TIMEOUT_S, device=DEVICE)
        # The straggler wakes after the run and finishes its duplicate
        # (dropped, not stored): its launches belong to this path too.
        t0 = time.perf_counter()
        for t in threading.enumerate():
            if t.name.startswith("sweep-ft-"):
                t.join(timeout=120)
                check(not t.is_alive(), f"sweep_ft: {t.name} still runs")
        _sync(torch)
        straggler_tail_s = time.perf_counter() - t0
        ft_launches = {n: m.launches for n, m in kernel_mods.items()}
        mesh = make_test_mesh(model=1, device=DEVICE)
        meshed, mesh_s = timed(run_sweep, spec, os.path.join(root, "mesh"),
                               device=DEVICE, mesh=mesh)
    finally:
        for u in undo:
            u()
    check(by_index(ft.records) == want,
          "sweep_ft: run_sweep_ft records differ from run_sweep's")
    check(ft.lost_workers == [1], f"sweep_ft: lost {ft.lost_workers}")
    check(ft.re_dispatched >= 1, f"sweep_ft: {ft.re_dispatched} re-dispatched")
    check(by_index(meshed.records) == want,
          "sweep_ft: the mesh run's records differ from run_sweep's")
    cuda_chunks = sum(1 for c in planner.plan(spec) if c.backend == "cuda")
    check(len(majx_batches) == cuda_chunks,
          f"sweep_ft: {len(majx_batches)} majx_batch calls on the mesh, "
          f"{cuda_chunks} cuda chunks")
    report = {
        "points": spec.n_points(), "words": WORDS, "workers": FT_WORKERS,
        "events": events, "lost_workers": ft.lost_workers,
        "re_dispatched": ft.re_dispatched,
        "worker_chunks": ft.worker_chunks,
        "executed_chunks": ft.executed_chunks,
        "fleet_slowdown": ft.fleet_slowdown,
        "single_wall_s": base_s, "ft_wall_s": ft_s,
        "straggler_tail_s": straggler_tail_s, "mesh_wall_s": mesh_s,
        "mesh": mesh.shape,
        "cuda_points_per_s": {"single": n_cuda / base_s,
                              "ft": n_cuda / ft_s,
                              "mesh": n_cuda / mesh_s},
        "launches_ft": ft_launches}
    emit({"phase": "sweep_ft", **report})
    return read_launches(kernel_mods, ("majx", "mismatch"), len(dispatches),
                         "sweep_ft")


# ------------------------------------------------------------ lm_serve
#: The models served at their published widths: chatglm3-6b (dense,
#: GQA kv=2, partial RoPE), musicgen-medium (audio, 4 codebooks),
#: zamba2-1.2b (hybrid: Mamba2 and a shared attention block),
#: xlstm-125m (ssm: mLSTM and sLSTM), mixtral-8x22b (MoE, 8 experts,
#: top-2, 4,096-token sliding window) and qwen3-moe-235b-a22b (MoE, 128
#: experts, top-8).  Each row: (arch, layers served (None: all),
#: prompt tokens, KV cache slots, layers of the card-vs-CPU check).
#: zamba2's prompts are a multiple of its 64-token ``ssm_chunk``, which
#: its Mamba2 needs.  The two MoE models are cut in depth to fit one
#: card (their widths are not cut).  ``LM_SMOKE`` swaps in the smoke
#: twins for a CPU rehearsal.
LM_SERVED = (
    ("chatglm3-6b", None, 16, 64, 2),
    ("musicgen-medium", None, 16, 64, 2),
    ("zamba2-1.2b", None, 64, 128, 7),
    ("xlstm-125m", None, 16, 64, 4),
    ("mixtral-8x22b", 4, 16, 64, 1),
    ("qwen3-moe-235b-a22b", 2, 16, 64, 1),
)
#: The models that also prefill LM_LONG tokens, streaming against dense.
LM_LONG_ARCHS = ("chatglm3-6b", "mixtral-8x22b")
LM_SMOKE = False
LM_SEED = 0
LM_REQUESTS = 8          # requests a generate call serves
LM_NEW = 16              # tokens generated a request
LM_LONG = 8448           # one prefill above the streaming threshold (8192)
LM_CHECK_BATCH = 4       # requests in the card-vs-CPU check
LM_TF_STEPS = 4          # teacher-forced decode steps in that check
#: Largest |difference| allowed, as a share of the largest |logit|:
#: float32 on the card against float32 on the CPU (both exact products,
#: TF32 off; only the summation order differs) ...
LM_F32_TOL = 1e-4
#: ... bfloat16 against float32 on the card (an 8-bit significand; the
#: CPU tests see about 1e-2 at smoke size, 2 layers) ...
LM_BF16_TOL = 3e-2
#: ... except for the recurrent families (hybrid, ssm), whose gates go
#: through ``exp``: there the reference's own bfloat16 logits differ
#: from its float32 ones by more than 3e-2, on the same weights
#: (``tests/test_torch_models.py::test_bf16_drift_of_the_recurrent_
#: families_is_the_reference_own``); this bound is about twice what the
#: card shows for zamba2 and xlstm ...
LM_BF16_TOL_RECURRENT = 1.5e-1
#: ... and the streaming prefill against the dense one, both bfloat16
#: over all 28 layers (a CPU rehearsal at smoke widths, 28 layers and
#: 8448 tokens gave 1.9e-2).
LM_LONG_TOL = 5e-2
#: Bits flipped in the bad replica of the heal: (leaf path, count).
LM_FLIPS = ((("embed", "tok"), 7), (("blocks", "attn", "wq"), 5),
            (("blocks", "ln1"), 3), (("blocks", "mlp", "w_down"), 11),
            (("head", "w"), 2), (("ln_f",), 1))


def progress(what: str, t0: float) -> None:
    """A line on standard error as each step of a long phase ends."""
    print(f"chip_smoke: {what} done at {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


def lm_config(arch: str, **changes):
    import dataclasses as dc

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch, smoke=LM_SMOKE)
    return dc.replace(cfg, **changes) if changes else cfg


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    from repro_torch.core import tree as tree_util

    leaves, structure = tree_util.flatten(tree)
    return tree_util.unflatten(structure, [fn(t) for t in leaves])


def tree_bytes(tree) -> int:
    from repro_torch.core import tree as tree_util

    return sum(t.numel() * t.element_size()
               for t in tree_util.flatten(tree)[0])


def lm_prompts(cfg, n: int, length: int, seed: int = LM_SEED):
    rng = np.random.default_rng(seed)
    shape = (length, cfg.n_codebooks) if cfg.family == "audio" else (length,)
    return [rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
            for _ in range(n)]


def decode_bound(cfg, params, cache, batch: int) -> dict:
    """The least time one decode step of ``batch`` tokens could take on
    ``cache`` (a prefill's): every weight read once (of the embedding
    tables only the rows the step looks up; every expert, as the
    capacity dispatch reads them all), each attention layer's KV buffer
    read once and one slot written, each recurrent state read and
    written once, against 2 * weights * batch operations at the bfloat16
    tensor-core peak."""
    from repro_torch.core import tree as tree_util
    from repro_torch.models.attention import KVCache

    kv = state = 0
    for node in list(cache.layers if isinstance(cache.layers, list)
                     else [cache.layers]) + list(cache.extra or []):
        if isinstance(node, KVCache):
            b, s, h, d = node.k.shape[-4:]
            layers = node.k.numel() // (b * s * h * d)
            kv += 2 * (layers * b * (s + 1) * h * d) * node.k.element_size()
        else:
            state += 2 * tree_bytes(node)
    emb = params["embed"]["tok"]
    n_lookups = batch * (cfg.n_codebooks or 1)
    weights = tree_bytes(params) - emb.numel() * emb.element_size() \
        + n_lookups * cfg.d_model * emb.element_size()
    n_params = sum(t.numel() for t in tree_util.flatten(params)[0])
    t_bytes = (weights + kv + state) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_params * batch / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "weight_bytes": weights, "kv_bytes": kv, "state_bytes": state}


def lm_generate(torch, eng, cfg, prompt: int) -> dict:
    """``Engine.generate`` over LM_REQUESTS requests of ``prompt`` tokens
    (after a one-request warm-up), each prefill and decode step timed to
    the card's end."""
    from repro_torch.serve.engine import Request

    prompts = lm_prompts(cfg, LM_REQUESTS, prompt)
    eng.generate([Request(rid=-1, prompt=prompts[0], max_new_tokens=2)])
    steps = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*args):
            _sync(torch)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(torch)
            steps[key].append(time.perf_counter() - t0)
            return out
        return run

    eng._prefill = timed(eng._prefill, "prefill")
    eng._decode = timed(eng._decode, "decode")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = eng.generate(reqs)
    wall = time.perf_counter() - t0
    del eng._prefill, eng._decode
    tok_shape = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    for r in done:
        toks = np.array(r.out_tokens)
        check(r.done and toks.shape == (LM_NEW,) + tok_shape and
              toks.min() >= 0 and toks.max() < cfg.vocab_size,
              f"{cfg.name}: request {r.rid} gave tokens of shape "
              f"{toks.shape}, range [{toks.min()}, {toks.max()}]")
    n_tok = sum(len(r.out_tokens) for r in done)
    check(len(steps["prefill"]) == 1 and len(steps["decode"]) == LM_NEW - 1,
          f"{cfg.name}: {steps} steps")
    return {"requests": len(done), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "prefill_ms": steps["prefill"][0] * 1e3,
            "decode_ms_median": statistics.median(steps["decode"]) * 1e3,
            "decode_ms": [s * 1e3 for s in steps["decode"]],
            "first_tokens": [int(np.asarray(t).flat[0])
                             for t in done[0].out_tokens[:8]]}


def profile_call(torch, fn) -> dict:
    """The card's busy share over one call of ``fn`` (a
    ``torch.profiler`` trace: device time of every kernel and copy, one
    stream, over the call's wall), its device ops and its six longest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(torch)
        wall = time.perf_counter() - t0
    busy, n_ops, kernels = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) / 1e6
            busy += t
            n_ops += e.count
            kernels.append((t, e.count, e.key[:80]))
    return {"profiled_step_s": wall, "device_busy_s": busy or None,
            "device_busy_share": busy / wall if busy else None,
            "device_ops": n_ops,
            "top_kernels": [{"name": k, "device_s": t, "count": c}
                            for t, c, k in sorted(kernels)[::-1][:6]]}


def decode_profile(torch, eng, toks, cache) -> dict:
    """:func:`profile_call` over one decode step of the prompts ``toks``
    after their prefill's ``cache`` (after one unprofiled step)."""
    step = toks[:, -1:]
    eng._decode(eng.params, step, cache)
    return profile_call(torch, lambda: eng._decode(eng.params, step, cache))


def rel_err(torch, got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def routing_agreement(routes_a, routes_b, layers: int, batch: int,
                      prompt: int) -> tuple[list, int]:
    """Where two runs of an MoE model routed alike: for each compared
    logits (the prefill's last position, then each decode step), a mask
    of the rows whose compared token chose the same experts in every
    layer and none of whose earlier tokens chose others below the last
    layer (later layers attend to those); and the count of tokens
    routed differently.  ``routes_*`` are each run's sorted top-k
    indices, one (1, tokens, k) tensor a layer call, in call order."""
    masks, tainted, differ = [], np.zeros(batch, bool), 0
    for step in range(len(routes_a) // layers):
        now = np.zeros(batch, bool)
        for layer in range(layers):
            call = step * layers + layer
            flip = (routes_a[call] != routes_b[call]).any(dim=-1).numpy()
            flip = flip.reshape(batch, prompt if step == 0 else 1)
            differ += int(flip.sum())
            now |= flip[:, -1]
            if layer < layers - 1:
                tainted |= flip.any(axis=1)
        masks.append(~(tainted | now))
    return masks, differ


def lm_check(torch, arch: str, layers: int, prompt: int,
             max_seq: int) -> dict:
    """At full width and ``layers`` layers, with one set of weights: the
    card's float32 prefill and teacher-forced decode logits against the
    CPU's, and the card's bfloat16 logits against its float32 ones.

    For an MoE model every routing decision is kept, and the tokens
    whose top-k expert set differs between the two runs compared are
    counted and printed: a near-tie can flip on a one-ulp difference of
    the router logits (card and CPU) or on bfloat16 rounding (many
    experts, as qwen3-moe's 128, make near-ties common).  A flipped
    token's logits are not those of the same function, so the rows
    :func:`routing_agreement` excludes are counted, not compared; every
    compared logits must keep at least one row."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfgs = {dt: lm_config(arch, n_layers=layers, dtype=dt)
            for dt in ("float32", "bfloat16")}
    prompts = np.stack(lm_prompts(cfgs["float32"], LM_CHECK_BATCH,
                                  prompt, seed=LM_SEED + 1))
    forced = lm_prompts(cfgs["float32"], LM_TF_STEPS, LM_CHECK_BATCH,
                        seed=LM_SEED + 2)
    routes = {"card": [], "cpu": [], "bf16": []}

    def run(params, cfg, device, record):
        """Prefill logits, then each teacher-forced step's logits."""
        out = []
        real_route = moe.route

        def route(*args):
            logits, topv, topi = real_route(*args)
            record.append(torch.sort(topi, dim=-1).values.cpu())
            return logits, topv, topi

        moe.route = route
        try:
            with torch.inference_mode():
                toks = torch.as_tensor(prompts, dtype=torch.int64,
                                       device=device)
                logits, cache = M.prefill(params, {"tokens": toks}, cfg,
                                          max_seq)
                out.append(logits)
                for step in forced:
                    tok = torch.as_tensor(step, dtype=torch.int64,
                                          device=device)[:, None]
                    logits, cache = M.decode(params, tok, cache, cfg)
                    out.append(logits)
        finally:
            moe.route = real_route
        return out

    # Equal seeds draw equal float32 normals: the bfloat16 weights are
    # the float32 ones rounded, the norms equal.
    p32, _ = M.init(LM_SEED, cfgs["float32"], device=DEVICE)
    card = run(p32, cfgs["float32"], DEVICE, routes["card"])
    host = run(tree_map(lambda t: t.cpu(), p32), cfgs["float32"], "cpu",
               routes["cpu"])
    del p32
    p16, _ = M.init(LM_SEED, cfgs["bfloat16"], device=DEVICE)
    low = run(p16, cfgs["bfloat16"], DEVICE, routes["bf16"])
    del p16
    report = {"layers": layers, "prompt": prompt, "rows": LM_CHECK_BATCH,
              "logit_shape": list(card[0].shape), "f32_tol": LM_F32_TOL,
              "bf16_tol": (LM_BF16_TOL_RECURRENT
                           if cfgs["float32"].family in ("hybrid", "ssm")
                           else LM_BF16_TOL)}
    for key, (got, want, ra, rb) in {
            "f32_card_vs_cpu": (card, host, "card", "cpu"),
            "bf16_vs_f32": (low, card, "bf16", "card")}.items():
        rows = [np.ones(LM_CHECK_BATCH, bool)] * len(got)
        if cfgs["float32"].is_moe:
            check(len(routes[ra]) == len(routes[rb]) == len(got) * layers,
                  f"{arch}: {len(routes[ra])} and {len(routes[rb])} "
                  f"routings for {len(got)} steps of {layers} layers")
            rows, differ = routing_agreement(routes[ra], routes[rb], layers,
                                             LM_CHECK_BATCH, prompt)
            report[f"{key}_routing_differs_tokens"] = differ
            report[f"{key}_rows_excluded"] = [int((~m).sum()) for m in rows]
            print(f"chip_smoke: {arch}: {key}: {differ} of "
                  f"{sum(r.shape[1] for r in routes[ra])} routed tokens "
                  f"chose other experts; rows left out of each compared "
                  f"logits {report[f'{key}_rows_excluded']}",
                  file=sys.stderr, flush=True)
            check(all(m.any() for m in rows),
                  f"{arch}: {key}: every row routed differently at some step")
        report[key] = [rel_err(torch, a.cpu()[torch.from_numpy(m)],
                               b.cpu()[torch.from_numpy(m)])
                       for a, b, m in zip(got, want, rows)]
    check(all(np.isfinite(x.float().cpu().numpy()).all()
              for x in card + low), f"{arch}: non-finite logits")
    f32, bf16 = report["f32_card_vs_cpu"], report["bf16_vs_f32"]
    check(max(f32) <= LM_F32_TOL, f"{arch}: float32 logits on the card "
          f"differ from the CPU's by {f32} of the largest")
    check(max(bf16) <= report["bf16_tol"], f"{arch}: bfloat16 logits "
          f"differ from float32 by {bf16} of the largest")
    return report


def lm_long_prefill(torch, params, cfg) -> dict:
    """One LM_LONG-token prefill, which takes the streaming attention
    path, against the dense path (``FORCE_DENSE``) on the same weights:
    the last position's logits."""
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M

    toks = torch.as_tensor(lm_prompts(cfg, 1, LM_LONG)[0][None],
                           dtype=torch.int64, device=DEVICE)
    out, secs = {}, {}
    with torch.inference_mode():
        for path in ("streaming", "dense"):
            attn.FORCE_DENSE = path == "dense"
            try:
                _sync(torch)
                t0 = time.perf_counter()
                out[path], _ = M.prefill(params, {"tokens": toks}, cfg,
                                         LM_LONG)
                _sync(torch)
                secs[path] = time.perf_counter() - t0
            finally:
                attn.FORCE_DENSE = False
    err = rel_err(torch, out["streaming"], out["dense"])
    check(bool(torch.isfinite(out["streaming"]).all()),
          "streaming prefill: non-finite logits")
    check(err <= LM_LONG_TOL, f"streaming prefill differs from dense by "
          f"{err} of the largest logit")
    return {"tokens": LM_LONG, "streaming_s": secs["streaming"],
            "dense_s": secs["dense"], "streaming_vs_dense": err,
            "tol": LM_LONG_TOL}


@contextlib.contextmanager
def spans(torch, targets):
    """Time every call of each ``(name, owner, attribute)`` target (the
    card synchronised before and after) into the yielded dict of
    seconds; the attributes are restored on exit."""
    secs = {name: 0.0 for name, _, _ in targets}
    saved = []
    start = time.perf_counter()
    for name, owner, attr in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, owner.__dict__[attr]))

        def wrapped(*args, _fn=fn, _name=name, **kw):
            _sync(torch)
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                _sync(torch)
                secs[_name] += time.perf_counter() - t0
                progress(f"span {_name}", start)
        setattr(owner, attr, wrapped)
    try:
        yield secs
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def flip_leaf_bits(torch, leaf, n: int, seed: int):
    """``leaf`` (a tensor) with ``n`` distinct bits flipped, and their
    count."""
    out = leaf.clone()
    words = out.view(-1).view(torch.int32) if out.element_size() == 4 \
        else out.view(-1).view(torch.int16)
    bits = out.element_size() * 8
    pos = np.random.default_rng(seed).choice(words.numel() * bits, n,
                                             replace=False)
    for p in pos.tolist():
        i, b = divmod(p, bits)
        mask = (1 << b) - (1 << bits if b == bits - 1 else 0)
        words[i] ^= mask
    return out


def lm_heal(torch, eng, cfg) -> dict:
    """``heal_params`` over three replicas, the first with LM_FLIPS bits
    flipped in six leaves; the healed params must equal the clean ones
    bit for bit and ``fixed_bits`` the flips.  Then ``verify_params``
    against the clean and the bad replica.  The heal's wall is split by
    timing each step it takes (the card synchronised around each)."""
    from repro_torch.backends.cuda import CudaBackend
    from repro_torch.core import bitplanes as bp
    from repro_torch.core import tree as tree_util
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.mismatch import ops as mismatch_ops
    from repro_torch.pud import offload
    from repro_torch.serve.batcher import Batcher
    from repro_torch.serve.engine import Engine
    from repro_torch.session.builder import SessionProgram
    from repro_torch.session.cache import CompileCache

    clean = eng.params
    bad = tree_map(lambda t: t, clean)
    n_flips = 0
    for i, (path, n) in enumerate(LM_FLIPS):
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = flip_leaf_bits(torch, node[path[-1]], n, seed=i)
        n_flips += n
    leaves = tree_util.flatten(clean)[0]
    total = sum(-(-t.numel() * t.element_size() // 4) for t in leaves)
    rows = -(-total // 4096)
    targets = [
        ("pack", Engine, "_pack_pytree"),
        ("heal_tick", Batcher, "_execute_heal"),
        ("validate", SessionProgram, "build"),
        ("image_build", SessionProgram, "initial_state"),
        ("schedule", CompileCache, "schedule_for"),
        ("certify", CompileCache, "certificate_for"),
        ("offload_plan", offload, "plan_program"),
        ("fused_run", CudaBackend, "run_fused"),
        ("upload", bp, "from_u32"),
        ("majx", majx_ops, "majx_batch"),
        ("mismatch", mismatch_ops, "mismatch_count"),
    ]
    _sync(torch)
    t0 = time.perf_counter()
    with spans(torch, targets) as split:
        fixed = eng.heal_params([bad, clean, clean])
    _sync(torch)
    heal_s = time.perf_counter() - t0
    split["other"] = heal_s - split["pack"] - split["heal_tick"]
    split["program_build"] = split["heal_tick"] - sum(
        split[k] for k in ("validate", "image_build", "schedule",
                           "certify", "offload_plan", "fused_run",
                           "mismatch"))
    healed = tree_util.flatten(eng.params)[0]
    check(all(a.dtype == b.dtype and a.shape == b.shape and
              torch.equal(a.reshape(-1).view(torch.uint8),
                          b.reshape(-1).view(torch.uint8))
              for a, b in zip(healed, leaves)),
          "heal: the healed params differ from the clean ones")
    check(fixed == n_flips, f"heal fixed {fixed} bits, {n_flips} planted")
    progress("heal", t0)
    eng.params = clean
    t0 = time.perf_counter()
    same = eng.verify_params(clean)
    verify_s = time.perf_counter() - t0
    progress("verify", t0)
    check(same == 1.0, f"verify_params(clean) = {same}")
    rate = eng.verify_params(bad)
    want = 1.0 - n_flips / max(total * 32, 1)
    check(rate == want, f"verify_params(bad) = {rate}, want {want}")
    del bad
    return {"rows": rows, "words": rows * 4096, "replicas": 3,
            "params_bytes": tree_bytes(clean), "flips": n_flips,
            "fixed_bits": fixed, "heal_s": heal_s, "split_s": split,
            "verify_s": verify_s, "verify_bad": rate}


def lm_kernels(torch, timer, rows: int) -> dict:
    """MAJX and the mismatch count at the heal's shape (3 x rows x 4096
    words, and 2 x rows x 4096) against their plain versions and their
    bytes bounds (after the launch count is read: not counted)."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels.majx import ops as majx_ops
    from repro_torch.kernels.mismatch import ops as mismatch_ops
    from repro_torch.kernels.mismatch.ref import mismatch_count_ref

    g = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    planes = torch.randint(-2**31, 2**31, (3, rows, 4096), generator=g,
                           device=DEVICE, dtype=torch.int32)
    words = rows * 4096
    got = majx_ops.majx(planes)
    want = bp.maj3_words(*planes)
    majx = {"shape": [3, rows, 4096],
            "max_abs_err": max_abs_err(torch, got, want)}
    check(majx["max_abs_err"] == 0, "MAJX at model size != plain MAJ3")
    del want
    majx["ms"] = timer(lambda: majx_ops.majx(planes), reps=5, warmup=1)
    majx["plain_ms"] = timer(lambda: bp.maj3_words(*planes), reps=3,
                             warmup=1)
    majx["bound_ms"], majx["bound_by"] = bound(4 * words * 4,
                                               words * vote_ops(3))
    a, b = planes[0].clone(), got
    del planes
    n = int(mismatch_ops.mismatch_count(a, b))
    ref = int(mismatch_count_ref(a, b))
    mism = {"shape": [2, rows, 4096], "count": n,
            "max_abs_err": abs(n - ref)}
    check(n == ref, f"mismatch at model size {n} != plain {ref}")
    mism["ms"] = timer(lambda: mismatch_ops.mismatch_count(a, b), reps=5,
                       warmup=1)
    mism["plain_ms"] = timer(lambda: mismatch_count_ref(a, b), reps=3,
                             warmup=1)
    mism["bound_ms"], mism["bound_by"] = bound(2 * words * 4, 3 * words)
    return {"majx": majx, "mismatch": mism}


def phase_lm_serve(torch, kernel_mods, timer) -> dict:
    """LM serving at full width: each model of LM_SERVED served by
    ``Engine.generate``, its decode step against its bound and
    profiled; the LM_LONG_ARCHS' streaming prefills against dense ones;
    musicgen-medium's params healed and verified through the service
    (MAJX and mismatch launches); each model at its check depth on the
    card against the CPU; returns each kernel's launches."""
    from repro_torch.core import tree as tree_util
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 checks would not be float32")
    svc = new_service(pool_size=1, tenant_rows=2**22)
    zero_launches(kernel_mods)
    start = sum(s.dispatch_count for s in svc.sessions)
    report, heal_rows = {}, None
    t_phase = time.perf_counter()
    for arch, layers, prompt, max_seq, check_layers in LM_SERVED:
        full = lm_config(arch)
        cfg = lm_config(arch, n_layers=layers) if layers else full
        _sync(torch)
        t0 = time.perf_counter()
        params, _ = M.init(LM_SEED, cfg, device=DEVICE)
        _sync(torch)
        progress(f"{arch}: init", t_phase)
        rep = {"layers": cfg.n_layers, "published_layers": full.n_layers,
               "prompt": prompt, "max_seq": max_seq,
               "init_s": time.perf_counter() - t0,
               "params": sum(t.numel() for t in
                             tree_util.flatten(params)[0]),
               "params_bytes": tree_bytes(params)}
        eng = Engine(params, cfg, max_seq=max_seq, pud_service=svc,
                     tenant=arch, device=DEVICE)
        rep["generate"] = lm_generate(torch, eng, cfg, prompt)
        toks = eng._tokens(np.stack(lm_prompts(cfg, LM_REQUESTS, prompt)))
        _, cache = eng._prefill(eng.params, {"tokens": toks})
        rep["decode_bound"] = decode_bound(cfg, params, cache, LM_REQUESTS)
        progress(f"{arch}: generate", t_phase)
        if DEVICE == "cuda":
            rep["decode_profile"] = decode_profile(torch, eng, toks, cache)
            progress(f"{arch}: decode profile", t_phase)
        del cache
        if arch in LM_LONG_ARCHS:
            rep["long_prefill"] = lm_long_prefill(torch, params, cfg)
            progress(f"{arch}: long prefill", t_phase)
        if cfg.family == "audio":
            rep["heal"] = lm_heal(torch, eng, cfg)
            heal_rows = rep["heal"]["rows"]
            progress(f"{arch}: heal and verify", t_phase)
        del eng, params
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        rep["check"] = lm_check(torch, arch, check_layers, prompt, max_seq)
        progress(f"{arch}: {check_layers}-layer checks", t_phase)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        report[arch] = rep
        emit({"phase": "lm_serve", "model": arch, **rep})
    dispatches = sum(s.dispatch_count for s in svc.sessions) - start
    launches = read_launches(kernel_mods, ("majx", "mismatch"), dispatches,
                             "lm_serve")
    check(launches["majx"] == 1 and launches["mismatch"] == 3,
          f"lm_serve: want 1 MAJX (the heal) and 3 mismatch launches (the "
          f"heal's count, two verifies), got {launches}")
    del svc
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        emit({"phase": "lm_serve", "kernels_at_heal_shape":
              lm_kernels(torch, timer, heal_rows)})
    return launches


# ------------------------------------------------------------ train
#: The models the ``train`` phase trains at their published width and
#: depth, each for TRAIN_STEPS steps through ``Trainer.run``: (arch,
#: batch, seq, compression).  musicgen-medium takes 4,096 positions a
#: step; xlstm-125m's batch is the reference's own full-width run
#: (``examples/train_tiny_lm.py``), with the int8 codec at full width.
TRAIN_RUNS = (("musicgen-medium", 8, 512, "none"),
              ("xlstm-125m", 4, 128, "int8"))
TRAIN_STEPS = 8
TRAIN_LR = 1e-3          # the reference example's learning rate
#: The card-against-CPU check: each model at full width and this depth
#: (xlstm's 4 layers reach its first sLSTM layer, layer 3), on a batch
#: of TRAIN_CHECK_BATCH x TRAIN_CHECK_SEQ.
TRAIN_CHECK = (("musicgen-medium", 2), ("xlstm-125m", 4))
TRAIN_CHECK_BATCH = 2
TRAIN_CHECK_SEQ = 64
#: float32 on the card against float32 on the CPU (TF32 off): the loss
#: within 1e-5 relative, each gradient leaf within 1e-4 of its largest
#: |g| (the CPU tests' tolerances against the reference).
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: The restart run: the reference's documented invocation
#: (``src/repro/launch/train.py:9-10``), on the card.
TRAIN_RESTART_ARGV = ("--arch", "xlstm-125m", "--smoke", "--steps", "40",
                      "--ckpt-every", "10", "--tmr", "3", "--fail-at", "25")
TRAIN_FLIP_BYTES = 64    # bytes of one replica's shard flipped


def train_bound(cfg, n_params: int, param_bytes: int, tokens: int,
                compression: str) -> dict:
    """The least time one train step could take: the larger of its
    matrix operations (2 N a token forward, 2 N again to recompute under
    remat, 4 N backward) at the bfloat16 tensor-core peak, and the
    optimizer's bytes over HBM's rate: each gradient (the params' dtype,
    ``param_bytes`` in all) read twice (norm, clip), m, v and the master
    copy read and written in float32, the params written; the int8
    codec adds a gradient read, the residual read and written and the
    decoded gradient written and read."""
    ops = (8 if cfg.remat != "none" else 6) * n_params * tokens
    n_bytes = 3 * param_bytes + 3 * 2 * 4 * n_params
    if compression != "none":
        n_bytes += param_bytes + 2 * 4 * n_params + 2 * 4 * n_params
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"compute_ms": t_ops, "optimizer_ms": t_bytes,
            "optimizer_bytes_per_param": n_bytes / n_params,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def train_split(torch, step_fn, state, batch) -> dict:
    """One train step's wall split into its gradient, codec and AdamW
    parts (the card synchronised around each)."""
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as comp
    from repro_torch.train import step as train_step

    with spans(torch, (("loss_and_grads", train_step, "loss_and_grads"),
                       ("compress", comp, "compress"),
                       ("apply_updates", adamw, "apply_updates"))) as secs:
        _sync(torch)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        _sync(torch)
        wall = time.perf_counter() - t0
    del out
    return {"step_s": wall, **secs}


def train_views_ab(torch, step_fn, state, batch) -> dict:
    """The step with the layers' views of the stacked params taken one
    ``select`` a layer (``common.layer``) against one ``unbind`` a leaf
    (``common.layers``, what ``forward`` uses), in turns (select,
    unbind, unbind, select; two steps each), then one profile of each."""
    from repro_torch.models import model as M
    from repro_torch.models.common import layer, layers

    variants = {"select": lambda tree, n: [layer(tree, i)
                                           for i in range(n)],
                "unbind": layers}
    walls = {k: [] for k in variants}
    out = {}
    try:
        for name in ("select", "unbind", "unbind", "select"):
            M.layers = variants[name]
            for _ in range(2):
                _sync(torch)
                t0 = time.perf_counter()
                step_fn(state, batch)
                _sync(torch)
                walls[name].append(time.perf_counter() - t0)
        for name in variants:
            M.layers = variants[name]
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
                prof = profile_call(torch, lambda: step_fn(state, batch))
                prof["peak_bytes"] = torch.cuda.max_memory_allocated()
                del prof["top_kernels"]
            else:
                prof = {}
            out[name] = {"walls_s": walls[name],
                         "median_s": statistics.median(walls[name]),
                         **prof}
    finally:
        M.layers = layers
    return out


#: Each ``train_run``'s largest peak of ``max_memory_allocated`` over
#: its steps, by arch (for the ``dryrun`` phase's one-card check).
TRAIN_PEAKS: dict = {}


def train_data(cfg, batch: int, seq: int, seed: int = LM_SEED):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, n_codebooks=cfg.n_codebooks))


def train_run(torch, arch: str, batch: int, seq: int,
              compression: str) -> dict:
    """``Trainer.run`` over TRAIN_STEPS steps of ``arch`` at full width
    and depth: each step's loss, wall and peak memory, one more step
    profiled, and the step's bound."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree as tree_util
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = lm_config(arch)
    tc = TrainConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=1,
                     compression=compression)
    data = train_data(cfg, batch, seq)
    trainer = Trainer(cfg, tc, data, TrainerConfig(log_every=TRAIN_STEPS),
                      log_fn=lambda line: print(line, file=sys.stderr,
                                                flush=True),
                      device=DEVICE)
    step_fn, peaks = trainer.step_fn, []

    def measured(state, b):
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = step_fn(state, b)
        _sync(torch)
        if DEVICE == "cuda":
            peaks.append(torch.cuda.max_memory_allocated())
        return out

    trainer.step_fn = measured
    t0 = time.perf_counter()
    hist = trainer.run(TRAIN_STEPS)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    check([h["step"] for h in hist] == list(range(TRAIN_STEPS)),
          f"{arch}: recorded steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(losses)), f"{arch}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}")
    state = trainer._state
    params = tree_util.flatten(state.params)[0]
    n_params = sum(t.numel() for t in params)
    rep = {"layers": cfg.n_layers, "batch": batch, "seq": seq,
           "tokens_per_step": batch * seq, "compression": compression,
           "remat": cfg.remat, "params": n_params,
           "state_bytes": tree_bytes(state), "run_s": wall,
           "steps": [{"step": h["step"], "loss": h["loss"],
                      "wall_s": h["time_s"],
                      "peak_bytes": peaks[i] if peaks else None}
                     for i, h in enumerate(hist)],
           "step_s_median": statistics.median(h["time_s"]
                                              for h in hist[1:]),
           "bound": train_bound(cfg, n_params, tree_bytes(state.params),
                                batch * seq, compression)}
    TRAIN_PEAKS[arch] = max(peaks) if peaks else None
    rep["split_s"] = train_split(torch, step_fn, state,
                                 data.batch(TRAIN_STEPS))
    if cfg.family != "ssm":   # the ssm family keeps a list of layers
        rep["views_ab"] = train_views_ab(torch, step_fn, state,
                                         data.batch(TRAIN_STEPS))
    if DEVICE == "cuda":
        batch_t = data.batch(TRAIN_STEPS)
        rep["profile"] = profile_call(torch,
                                      lambda: step_fn(state, batch_t))
    del trainer, state, params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return rep


def flip_shard_bytes(path: str, n: int) -> str:
    """Flip ``n`` bytes in the middle of the largest leaf of a replica's
    shard and write it back (the archive stays readable; the manifest's
    crc32 fails); returns the leaf's key."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    key = max(arrays, key=lambda k: arrays[k].nbytes)
    raw = arrays[key].view(np.uint8).reshape(-1)
    mid = raw.size // 2
    raw[mid:mid + n] ^= 0xA5
    np.savez(path, **arrays)
    return key


def train_restart(torch, kernel_mods) -> dict:
    """``launch.train.main`` with a failure at step 25 and a TMR store of
    three replicas on the card; then the step-40 checkpoint restored
    from a clean replica, one replica corrupted, and the store's voted
    restore through the MAJX kernel (one launch a leaf) and the plain
    vote, each bit-equal to the clean checkpoint."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.ckpt import tmr_store
    from repro_torch.core import tree as tree_util
    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.step import init_train_state

    trainers, real_run = [], trainer_mod.Trainer.run

    def run(self, steps):
        trainers.append(self)
        return real_run(self, steps)

    rep, secs = {"argv": list(TRAIN_RESTART_ARGV)}, {}
    with tempfile.TemporaryDirectory(prefix="train_ckpt") as d:
        out = io.StringIO()
        trainer_mod.Trainer.run = run
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = launch_train.main(list(TRAIN_RESTART_ARGV) + [
                    "--device", DEVICE, "--ckpt-dir", d])
            secs["main"] = time.perf_counter() - t0
        finally:
            trainer_mod.Trainer.run = real_run
        lines = out.getvalue().splitlines()
        check(rc == 0 and len(trainers) == 1, f"train main: rc {rc}, "
              f"{len(trainers)} trainers")
        trainer = trainers[0]
        hist = trainer.history
        steps = [h["step"] for h in hist]
        losses = [h["loss"] for h in hist]
        check(steps == list(range(25)) + list(range(20, 40)),
              f"restart: recorded steps {steps}")
        check("[trainer] restored step 20" in lines and any(
            "FAILURE: node_loss at step 25" in ln for ln in lines),
            f"restart: log {lines}")
        check(lines[-1].startswith("[train] xlstm-smoke: loss ") and
              lines[-1].endswith(f"over {len(hist)} recorded steps"),
              f"restart: last line {lines[-1]!r}")
        check(all(np.isfinite(losses)) and
              np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"restart: the loss did not fall: {losses}")
        cfg = trainer.cfg
        proto, _ = init_train_state(trainer.tc.seed, cfg, device=DEVICE)
        leaves = tree_util.flatten(proto)[0]
        t0 = time.perf_counter()
        want, at = ckpt.restore(proto, os.path.join(d, "replica_0"))
        secs["restore_clean"] = time.perf_counter() - t0
        want_leaves = tree_util.flatten(want)[0]

        def same(tree) -> bool:
            return all(a.device == b.device and a.dtype == b.dtype and
                       torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8))
                       for a, b in zip(tree_util.flatten(tree)[0],
                                       want_leaves))

        check(at == 40 and same(trainer._state),
              f"restart: the step-{at} checkpoint != the trained state")
        shard = os.path.join(d, "replica_1", "step_00000040",
                             "shard_p0.npz")
        rep["flipped_leaf"] = flip_shard_bytes(shard, TRAIN_FLIP_BYTES)
        try:
            ckpt.restore(proto, os.path.join(d, "replica_1"))
        except IOError as err:
            check("crc mismatch" in str(err), f"corruption: {err}")
        else:
            raise AssertionError("the corrupted replica restored verified")
        for use_kernel in (True, False):
            before = kernel_mods["majx"].launches
            t0 = time.perf_counter()
            got, at, bad = tmr_store.restore(proto, d, use_kernel=use_kernel)
            _sync(torch)
            key = "restore_kernel" if use_kernel else "restore_plain"
            secs[key] = time.perf_counter() - t0
            majx = kernel_mods["majx"].launches - before
            want_majx = len(leaves) if use_kernel and DEVICE == "cuda" else 0
            check((at, bad) == (40, 1), f"{key}: step {at}, {bad} bad")
            check(majx == want_majx, f"{key}: {majx} MAJX launches for "
                  f"{len(leaves)} leaves")
            check(same(got), f"{key} != the clean step-40 checkpoint")
    rep.update({"recorded_steps": len(hist), "losses": losses,
                "step_s_median": statistics.median(h["time_s"]
                                                   for h in hist),
                "leaves": len(leaves), "state_bytes": tree_bytes(proto),
                "host_s": secs, "last_line": lines[-1]})
    return rep


def train_check(torch, arch: str, layers: int) -> dict:
    """At full width and ``layers`` layers, one set of float32 weights on
    the card and the CPU: ``loss_fn`` and every gradient leaf; one
    ``make_train_step`` at ``microbatches=1`` against ``=2`` on the card
    (the reference's test tolerances); the bfloat16 loss against the
    float32 one."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree as tree_util
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as comp
    from repro_torch.train import step as train_step

    cfg32 = lm_config(arch, n_layers=layers, dtype="float32")
    cfg16 = lm_config(arch, n_layers=layers)
    batch = train_data(cfg32, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                       seed=LM_SEED + 3).batch(0)
    # Equal seeds draw equal float32 normals: the bfloat16 weights are
    # the float32 ones rounded, the norms equal.
    p32, _ = M.init(LM_SEED, cfg32, device=DEVICE)
    out = {}
    for where, params in (("card", p32),
                          ("cpu", tree_map(lambda t: t.cpu(), p32))):
        dev = tree_util.flatten(params)[0][0].device
        loss, _, grads = train_step.loss_and_grads(
            params, train_step.batch_to(batch, dev), cfg32, 1e-4)
        out[where] = (loss.cpu(), [g.cpu() for g in
                                   tree_util.flatten(grads)[0]])
    loss_err = rel_err(torch, out["card"][0], out["cpu"][0])
    grad_errs = [float((a - b).abs().max() / b.abs().max())
                 if float(b.abs().max()) > 0 else float(a.abs().max())
                 for a, b in zip(out["card"][1], out["cpu"][1])]
    names = [n for n, _ in tree_util.flatten_with_path(p32)[0]]
    worst = names[int(np.argmax(grad_errs))]
    check(all(bool(torch.isfinite(g).all()) for g in out["card"][1]),
          f"{arch}: non-finite gradients on the card")
    check(loss_err <= TRAIN_LOSS_TOL, f"{arch}: the card's loss differs "
          f"from the CPU's by {loss_err}")
    check(max(grad_errs) <= TRAIN_GRAD_TOL, f"{arch}: a gradient leaf on "
          f"the card differs from the CPU's by {max(grad_errs)} of its "
          f"largest")
    del out
    state = train_step.TrainState(p32, adamw.init_state(p32),
                                  comp.init_feedback(p32))
    mb = {}
    for n in (1, 2):
        new, metrics = train_step.make_train_step(
            cfg32, TrainConfig(microbatches=n))(state, batch)
        mb[n] = (float(metrics["loss"]), tree_util.flatten(new.params)[0])
    mb_loss = abs(mb[1][0] - mb[2][0]) / abs(mb[2][0])
    mb_param = max(float((a - b).abs().max())
                   for a, b in zip(mb[1][1], mb[2][1]))
    check(mb_loss <= 1e-3 and mb_param <= 5e-3, f"{arch}: microbatches 2 "
          f"against 1: loss {mb_loss} relative, params {mb_param}")
    del state, mb
    p16, _ = M.init(LM_SEED, cfg16, device=DEVICE)
    with torch.no_grad():
        b = train_step.batch_to(batch, DEVICE)
        l16, _ = M.loss_fn(p16, b, cfg16)
        l32, _ = M.loss_fn(p32, b, cfg32)
    check(bool(torch.isfinite(l16)), f"{arch}: non-finite bfloat16 loss")
    return {"layers": layers, "batch": TRAIN_CHECK_BATCH,
            "seq": TRAIN_CHECK_SEQ, "loss_card_vs_cpu": loss_err,
            "grad_card_vs_cpu_max": max(grad_errs),
            "grad_card_vs_cpu_worst_leaf": worst,
            "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
            "microbatch_loss_rel": mb_loss, "microbatch_param_abs": mb_param,
            "loss_f32": float(l32), "loss_bf16": float(l16),
            "loss_bf16_vs_f32": abs(float(l16) - float(l32))
            / abs(float(l32))}


def phase_train(torch, kernel_mods) -> dict:
    """Training on the card: each model of TRAIN_RUNS trained at full
    width and depth by ``Trainer.run``; the launcher's restart from a
    TMR store, voted through MAJX; each model of TRAIN_CHECK on the card
    against the CPU; returns each kernel's launches."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 checks would not be float32")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    zero_launches(kernel_mods)
    t_phase = time.perf_counter()
    for arch, batch, seq, compression in TRAIN_RUNS:
        rep = train_run(torch, arch, batch, seq, compression)
        progress(f"train {arch}", t_phase)
        emit({"phase": "train", "model": arch, **rep})
    restart = train_restart(torch, kernel_mods)
    progress("train restart and TMR restore", t_phase)
    emit({"phase": "train", "restart": restart})
    for arch, layers in TRAIN_CHECK:
        rep = train_check(torch, arch, layers)
        progress(f"train {arch}: {layers}-layer checks", t_phase)
        emit({"phase": "train", "model": arch, "check": rep})
    want = restart["leaves"] if DEVICE == "cuda" else 0
    return read_launches(kernel_mods, ("majx",), want, "train")


# ------------------------------------------------------------ dryrun
#: The fake-world cells: (arch, shape, multi-pod).  Four families at
#: train_4k, two decode cells (one with its experts split over the tp
#: axis), a 500k-token cell and one on the multi-pod mesh; each runs in
#: a process of its own, all at once.  zamba2-1.2b's and xlstm-125m's
#: train_4k cells take 2 and 7 minutes to count (their recurrences,
#: step by step): they run in ``--all``, not here.
DRYRUN_CELLS = (("chatglm3-6b", "train_4k", False),
                ("mixtral-8x22b", "train_4k", False),
                ("qwen3-moe-235b-a22b", "decode_32k", False),
                ("musicgen-medium", "train_4k", False),
                ("phi-3-vision-4.2b", "train_4k", False),
                ("chatglm3-6b", "decode_32k", False),
                ("xlstm-125m", "long_500k", False),
                ("chatglm3-6b", "decode_32k", True))
#: Grad-accumulation microbatches of the train cells (the reference's
#: dry run defaults to 4, which takes about twice as long to count).
DRYRUN_MICROBATCHES = 1
DRYRUN_TIMEOUT = 900     # seconds a cell's process may take
#: The one-card count of a ``train`` run, in a process of its own: a
#: one-device mesh on ``meta`` (no DTensor, no card), the run's config,
#: batch, sequence and codec.
DRYRUN_ONE_CARD = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.dist.sharding import Mesh
from repro_torch.launch.dryrun import count_cell
arch, batch, seq, codec, smoke = sys.argv[1:6]
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=int(seq),
                            global_batch=int(batch))
mesh = Mesh([[torch.device("meta")]], ("data", "model"))
c = count_cell(get_config(arch, smoke=smoke == "1"), shape, mesh,
               tc=TrainConfig(compression=codec))
print(json.dumps({"flops": c.flops, "bytes_accessed": c.bytes_accessed,
                  "peak_bytes": c.peak_bytes,
                  "argument_bytes": c.argument_bytes, "run_s": c.wall_s,
                  "local_ops": c.local_ops}))
"""


def dryrun_procs(cmds: list) -> list:
    """Run each command in a process of its own, all at once, with
    ``src/`` on the path and no card visible; each ``(rc, stdout,
    stderr, wall_s)``.  Every process is waited for or killed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0, procs = time.perf_counter(), []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(
                [sys.executable] + cmd, env=env, cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        out = []
        for p in procs:
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, DRYRUN_TIMEOUT
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                stderr += f"\nkilled after {DRYRUN_TIMEOUT} s"
            out.append((p.returncode, stdout, stderr,
                        time.perf_counter() - t0))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_dryrun() -> dict:
    """The dry run's cells on a fake world, and its one-card count of the
    ``train`` phase's runs beside what the card measured there."""
    import tempfile

    smoke = "1" if LM_SMOKE else "0"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun") as d:
        cmds = []
        for i, (arch, shape, multi) in enumerate(DRYRUN_CELLS):
            cmds.append(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                         "--shape", shape, "--microbatches",
                         str(DRYRUN_MICROBATCHES),
                         "--out", os.path.join(d, f"{i}.json")]
                        + ["--multipod"] * multi)
        for arch, batch, seq, codec in TRAIN_RUNS:
            cmds.append(["-c", DRYRUN_ONE_CARD, arch, str(batch), str(seq),
                         codec, smoke])
        done = dryrun_procs(cmds)
        cells = []
        for i, (arch, shape, multi) in enumerate(DRYRUN_CELLS):
            rc, stdout, stderr, wall = done[i]
            try:
                with open(os.path.join(d, f"{i}.json")) as f:
                    (row,) = json.load(f)
            except (OSError, ValueError):
                row = {"status": "error", "error": stderr[-2000:]}
            check(row["status"] in ("ok", "skipped"),
                  f"dryrun {arch} {shape}: {row.get('error', row)}")
            check(rc == 0, f"dryrun {arch} {shape}: exit {rc}: "
                  f"{stderr[-2000:]}")
            r = row.get("roofline", {})
            cell = {"arch": arch, "shape": shape, "status": row["status"],
                    "mesh": row.get("mesh"), "process_wall_s": wall,
                    "count_s": row.get("compile_s"),
                    "memory_gb": row.get("memory", {}).get("total_gb"),
                    "flops_per_chip": row.get("counts", {}).get(
                        "flops_per_chip"),
                    "bytes_per_chip": row.get("counts", {}).get(
                        "bytes_per_chip"),
                    "collective_gb_by_kind": row.get(
                        "collectives", {}).get("per_kind_gb"),
                    "collective_ops": row.get("collectives", {}).get(
                        "n_ops"),
                    "bound": r.get("bottleneck"),
                    "t_compute_s": r.get("t_compute_s"),
                    "t_memory_s": r.get("t_memory_s"),
                    "t_collective_s": r.get("t_collective_s"),
                    "roofline_fraction": r.get("roofline_fraction"),
                    "dtensor_ops": row.get("counts", {}).get("dtensor_ops")}
            if row["status"] == "ok":
                check(cell["flops_per_chip"] > 0 and cell["collective_ops"]
                      > 0 and cell["memory_gb"] > 0,
                      f"dryrun {arch} {shape}: empty counts {cell}")
            cells.append(cell)
            emit({"phase": "dryrun", "cell": cell})
        progress("dryrun fake-world cells", t_phase)
        one_card = []
        for j, (arch, batch, seq, codec) in enumerate(TRAIN_RUNS):
            rc, stdout, stderr, wall = done[len(DRYRUN_CELLS) + j]
            check(rc == 0, f"dryrun one-card {arch}: {stderr[-2000:]}")
            got = json.loads(stdout.strip().splitlines()[-1])
            cfg = lm_config(arch)
            n = cfg.n_params()
            bound_ops = (8 if cfg.remat != "none" else 6) * n * batch * seq
            measured = TRAIN_PEAKS.get(arch)
            rep = {"arch": arch, "batch": batch, "seq": seq, "codec": codec,
                   "flops": got["flops"], "train_bound_ops": bound_ops,
                   "flops_over_bound_ops": got["flops"] / bound_ops,
                   "predicted_peak_bytes": got["peak_bytes"],
                   "measured_peak_bytes": measured,
                   "predicted_over_measured": (got["peak_bytes"] / measured
                                               if measured else None),
                   "state_and_batch_bytes": got["argument_bytes"],
                   "count_s": got["run_s"], "process_wall_s": wall}
            check(got["flops"] > 0 and got["peak_bytes"]
                  > got["argument_bytes"],
                  f"dryrun one-card {arch}: {got}")
            one_card.append(rep)
            emit({"phase": "dryrun", "one_card": rep})
    return {"cells": cells, "one_card": one_card,
            "wall_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- paper

#: Steps of ``train_tiny_lm`` in the paper phase (its small config), and
#: the step its injected failure hits.
PAPER_TRAIN_ARGV = ("--small", "--steps", "12", "--fail-at", "7")


def paper_frozen(name: str, derived: str):
    """The part of a figure row the script holds frozen: the whole
    ``derived`` of an analytic figure; Fig 18's dispatches and in-situ
    DRAM energy (its launch energies are the H100 CostModel's prices);
    nothing of a kernel bench row (``None``)."""
    if name.startswith("kernel_"):
        return None
    if not name.startswith("fig18_") or name.endswith("_pud_dram"):
        return derived
    if name.endswith(("_per_op", "_fused", "_megakernel")):
        return next(f for f in derived.split(";")
                    if f.startswith("dispatches="))
    return None


#: The rows ``python -m repro_torch.paper.run`` prints without dry-run
#: files, in order, each with its deterministic part
#: (:func:`paper_frozen`; ``None`` where nothing is frozen), as the
#: reference prints it: ``tests/test_torch_paper.py`` holds them so.
PAPER_ROWS = {
    'fig3_simra_n2_t1_1.5_t2_1.5': 'success=0.9274',
    'fig3_simra_n4_t1_1.5_t2_1.5': 'success=0.8550',
    'fig3_simra_n8_t1_1.5_t2_1.5': 'success=0.7825',
    'fig3_simra_n16_t1_1.5_t2_1.5': 'success=0.7101',
    'fig3_simra_n32_t1_1.5_t2_1.5': 'success=0.6367',
    'fig3_simra_n2_t1_1.5_t2_3.0': 'success=0.9989',
    'fig3_simra_n4_t1_1.5_t2_3.0': 'success=0.9989',
    'fig3_simra_n8_t1_1.5_t2_3.0': 'success=0.9989',
    'fig3_simra_n16_t1_1.5_t2_3.0': 'success=0.9989',
    'fig3_simra_n32_t1_1.5_t2_3.0': 'success=0.9975',
    'fig3_simra_n2_t1_3.0_t2_1.5': 'success=0.9637',
    'fig3_simra_n4_t1_3.0_t2_1.5': 'success=0.9274',
    'fig3_simra_n8_t1_3.0_t2_1.5': 'success=0.8912',
    'fig3_simra_n16_t1_3.0_t2_1.5': 'success=0.8550',
    'fig3_simra_n32_t1_3.0_t2_1.5': 'success=0.8176',
    'fig3_simra_n2_t1_3.0_t2_3.0': 'success=0.9999',
    'fig3_simra_n4_t1_3.0_t2_3.0': 'success=0.9999',
    'fig3_simra_n8_t1_3.0_t2_3.0': 'success=0.9999',
    'fig3_simra_n16_t1_3.0_t2_3.0': 'success=0.9999',
    'fig3_simra_n32_t1_3.0_t2_3.0': 'success=0.9985',
    'fig4a_simra32_T50': 'success=0.9985',
    'fig4a_simra32_T60': 'success=0.9983',
    'fig4a_simra32_T70': 'success=0.9982',
    'fig4a_simra32_T80': 'success=0.9980',
    'fig4a_simra32_T90': 'success=0.9978',
    'fig4b_simra32_V2.5': 'success=0.9985',
    'fig4b_simra32_V2.4': 'success=0.9975',
    'fig4b_simra32_V2.3': 'success=0.9965',
    'fig4b_simra32_V2.2': 'success=0.9954',
    'fig4b_simra32_V2.1': 'success=0.9944', 'fig5_power_RD': 'watts=1.300',
    'fig5_power_WR': 'watts=1.250', 'fig5_power_ACT_PRE': 'watts=0.900',
    'fig5_power_REF': 'watts=1.800', 'fig5_power_SIMRA_2': 'watts=0.945',
    'fig5_power_SIMRA_4': 'watts=1.063', 'fig5_power_SIMRA_8': 'watts=1.182',
    'fig5_power_SIMRA_16': 'watts=1.300', 'fig5_power_SIMRA_32': 'watts=1.419',
    'fig5_simra32_vs_ref': 'delta=-0.2119',
    'fig6_maj3_n4_t1_1.5_t2_3.0': 'success=0.7568',
    'fig6_maj3_n8_t1_1.5_t2_3.0': 'success=0.8345',
    'fig6_maj3_n16_t1_1.5_t2_3.0': 'success=0.9123',
    'fig6_maj3_n32_t1_1.5_t2_3.0': 'success=0.9900',
    'fig6_maj3_n4_t1_3.0_t2_3.0': 'success=0.5202',
    'fig6_maj3_n8_t1_3.0_t2_3.0': 'success=0.5736',
    'fig6_maj3_n16_t1_3.0_t2_3.0': 'success=0.6270',
    'fig6_maj3_n32_t1_3.0_t2_3.0': 'success=0.6804',
    'fig6_maj3_n4_t1_4.5_t2_3.0': 'success=0.3962',
    'fig6_maj3_n8_t1_4.5_t2_3.0': 'success=0.4369',
    'fig6_maj3_n16_t1_4.5_t2_3.0': 'success=0.4776',
    'fig6_maj3_n32_t1_4.5_t2_3.0': 'success=0.5183',
    'fig6_maj3_n4_t1_1.5_t2_1.5': 'success=0.2270',
    'fig6_maj3_n8_t1_1.5_t2_1.5': 'success=0.2504',
    'fig6_maj3_n16_t1_1.5_t2_1.5': 'success=0.2737',
    'fig6_maj3_n32_t1_1.5_t2_1.5': 'success=0.2970',
    'fig6_cliff_t1_at_0.5': 'bracket=4.5..6ns',
    'fig6_cliff_t1_at_0.9': 'bracket=1.5..3ns',
    'fig6_cliff_economy': 'probed=7/20', 'fig7_maj3_random': 'success=0.9900',
    'fig7_maj3_0x00_0xFF': 'success=0.9968',
    'fig7_maj3_0xAA_0x55': 'success=0.9958',
    'fig7_maj3_0xCC_0x33': 'success=0.9948',
    'fig7_maj3_0x66_0x99': 'success=0.9953',
    'fig7_maj5_random': 'success=0.7964',
    'fig7_maj5_0x00_0xFF': 'success=0.9244',
    'fig7_maj5_0xAA_0x55': 'success=0.9235',
    'fig7_maj5_0xCC_0x33': 'success=0.9226',
    'fig7_maj5_0x66_0x99': 'success=0.9230',
    'fig7_maj7_random': 'success=0.3387',
    'fig7_maj7_0x00_0xFF': 'success=0.5022',
    'fig7_maj7_0xAA_0x55': 'success=0.5017',
    'fig7_maj7_0xCC_0x33': 'success=0.5012',
    'fig7_maj7_0x66_0x99': 'success=0.5015',
    'fig7_maj9_random': 'success=0.0591',
    'fig7_maj9_0x00_0xFF': 'success=0.0708',
    'fig7_maj9_0xAA_0x55': 'success=0.0707',
    'fig7_maj9_0xCC_0x33': 'success=0.0706',
    'fig7_maj9_0x66_0x99': 'success=0.0707',
    'fig8_maj3_n4_T50': 'success=0.7568',
    'fig8_maj3_n32_T50': 'success=0.9900',
    'fig8_maj3_n4_T60': 'success=0.7856',
    'fig8_maj3_n32_T60': 'success=0.9941',
    'fig8_maj3_n4_T70': 'success=0.8143',
    'fig8_maj3_n32_T70': 'success=0.9982',
    'fig8_maj3_n4_T80': 'success=0.8431',
    'fig8_maj3_n32_T80': 'success=1.0000',
    'fig8_maj3_n4_T90': 'success=0.8719',
    'fig8_maj3_n32_T90': 'success=1.0000',
    'fig8_maj5_n8_T50': 'success=0.5096',
    'fig8_maj5_n32_T50': 'success=0.7964',
    'fig8_maj5_n8_T60': 'success=0.5290',
    'fig8_maj5_n32_T60': 'success=0.8033',
    'fig8_maj5_n8_T70': 'success=0.5484',
    'fig8_maj5_n32_T70': 'success=0.8102',
    'fig8_maj5_n8_T80': 'success=0.5677',
    'fig8_maj5_n32_T80': 'success=0.8171',
    'fig8_maj5_n8_T90': 'success=0.5871',
    'fig8_maj5_n32_T90': 'success=0.8239',
    'fig8_maj7_n8_T50': 'success=0.2506',
    'fig8_maj7_n32_T50': 'success=0.3387',
    'fig8_maj7_n8_T60': 'success=0.2601',
    'fig8_maj7_n32_T60': 'success=0.3416',
    'fig8_maj7_n8_T70': 'success=0.2697',
    'fig8_maj7_n32_T70': 'success=0.3446',
    'fig8_maj7_n8_T80': 'success=0.2792',
    'fig8_maj7_n32_T80': 'success=0.3475',
    'fig8_maj7_n8_T90': 'success=0.2887',
    'fig8_maj7_n32_T90': 'success=0.3504',
    'fig8_maj9_n16_T50': 'success=0.0523',
    'fig8_maj9_n32_T50': 'success=0.0591',
    'fig8_maj9_n16_T60': 'success=0.0542',
    'fig8_maj9_n32_T60': 'success=0.0602',
    'fig8_maj9_n16_T70': 'success=0.0562',
    'fig8_maj9_n32_T70': 'success=0.0612',
    'fig8_maj9_n16_T80': 'success=0.0582',
    'fig8_maj9_n32_T80': 'success=0.0623',
    'fig8_maj9_n16_T90': 'success=0.0602',
    'fig8_maj9_n32_T90': 'success=0.0634', 'fig9_maj3_V2.5': 'success=0.9900',
    'fig9_maj3_V2.4': 'success=0.9873', 'fig9_maj3_V2.3': 'success=0.9846',
    'fig9_maj3_V2.2': 'success=0.9818', 'fig9_maj3_V2.1': 'success=0.9791',
    'fig9_maj5_V2.5': 'success=0.7964', 'fig9_maj5_V2.4': 'success=0.7942',
    'fig9_maj5_V2.3': 'success=0.7920', 'fig9_maj5_V2.2': 'success=0.7898',
    'fig9_maj5_V2.1': 'success=0.7876', 'fig9_maj7_V2.5': 'success=0.3387',
    'fig9_maj7_V2.4': 'success=0.3378', 'fig9_maj7_V2.3': 'success=0.3368',
    'fig9_maj7_V2.2': 'success=0.3359', 'fig9_maj7_V2.1': 'success=0.3350',
    'fig9_maj9_V2.5': 'success=0.0591', 'fig9_maj9_V2.4': 'success=0.0589',
    'fig9_maj9_V2.3': 'success=0.0588', 'fig9_maj9_V2.2': 'success=0.0586',
    'fig9_maj9_V2.1': 'success=0.0584', 'fig10_mrc1_t1_1.5': 'success=0.42677',
    'fig10_mrc3_t1_1.5': 'success=0.42674',
    'fig10_mrc7_t1_1.5': 'success=0.42678',
    'fig10_mrc15_t1_1.5': 'success=0.42678',
    'fig10_mrc31_t1_1.5': 'success=0.42671',
    'fig10_mrc1_t1_3.0': 'success=0.84997',
    'fig10_mrc3_t1_3.0': 'success=0.84991',
    'fig10_mrc7_t1_3.0': 'success=0.84998',
    'fig10_mrc15_t1_3.0': 'success=0.84999',
    'fig10_mrc31_t1_3.0': 'success=0.84985',
    'fig10_mrc1_t1_6.0': 'success=0.92996',
    'fig10_mrc3_t1_6.0': 'success=0.92990',
    'fig10_mrc7_t1_6.0': 'success=0.92998',
    'fig10_mrc15_t1_6.0': 'success=0.92999',
    'fig10_mrc31_t1_6.0': 'success=0.92983',
    'fig10_mrc1_t1_9.0': 'success=0.96996',
    'fig10_mrc3_t1_9.0': 'success=0.96989',
    'fig10_mrc7_t1_9.0': 'success=0.96998',
    'fig10_mrc15_t1_9.0': 'success=0.96999',
    'fig10_mrc31_t1_9.0': 'success=0.96983',
    'fig10_mrc1_t1_36.0': 'success=0.99996',
    'fig10_mrc3_t1_36.0': 'success=0.99989',
    'fig10_mrc7_t1_36.0': 'success=0.99998',
    'fig10_mrc15_t1_36.0': 'success=0.99999',
    'fig10_mrc31_t1_36.0': 'success=0.99982',
    'fig11_mrc1_0x00': 'success=0.99996', 'fig11_mrc3_0x00': 'success=0.99989',
    'fig11_mrc7_0x00': 'success=0.99998',
    'fig11_mrc15_0x00': 'success=0.99999',
    'fig11_mrc31_0x00': 'success=0.99982',
    'fig11_mrc1_0xFF': 'success=0.99886', 'fig11_mrc3_0xFF': 'success=0.99879',
    'fig11_mrc7_0xFF': 'success=0.99888',
    'fig11_mrc15_0xFF': 'success=0.99889',
    'fig11_mrc31_0xFF': 'success=0.99192',
    'fig11_mrc1_random': 'success=0.99996',
    'fig11_mrc3_random': 'success=0.99989',
    'fig11_mrc7_random': 'success=0.99998',
    'fig11_mrc15_random': 'success=0.99999',
    'fig11_mrc31_random': 'success=0.99982',
    'fig12a_mrc31_T50': 'success=0.99982',
    'fig12a_mrc31_T60': 'success=0.99972',
    'fig12a_mrc31_T70': 'success=0.99962',
    'fig12a_mrc31_T80': 'success=0.99952',
    'fig12a_mrc31_T90': 'success=0.99942',
    'fig12b_mrc31_V2.5': 'success=0.99982',
    'fig12b_mrc31_V2.4': 'success=0.99652',
    'fig12b_mrc31_V2.3': 'success=0.99322',
    'fig12b_mrc31_V2.2': 'success=0.98992',
    'fig12b_mrc31_V2.1': 'success=0.98662',
    'fig15_n1_pv0': 'dev=0.0736;success=1.0000',
    'fig15_n1_pv10': 'dev=0.0736;success=1.0000',
    'fig15_n1_pv20': 'dev=0.0736;success=1.0000',
    'fig15_n1_pv30': 'dev=0.0732;success=1.0000',
    'fig15_n1_pv40': 'dev=0.0727;success=0.9538',
    'fig15_n4_pv0': 'dev=0.0511;success=1.0000',
    'fig15_n4_pv10': 'dev=0.0510;success=0.6208',
    'fig15_n4_pv20': 'dev=0.0509;success=0.5680',
    'fig15_n4_pv30': 'dev=0.0508;success=0.5378',
    'fig15_n4_pv40': 'dev=0.0506;success=0.5265',
    'fig15_n8_pv0': 'dev=0.0725;success=1.0000',
    'fig15_n8_pv10': 'dev=0.0724;success=1.0000',
    'fig15_n8_pv20': 'dev=0.0722;success=0.9920',
    'fig15_n8_pv30': 'dev=0.0723;success=0.9383',
    'fig15_n8_pv40': 'dev=0.0723;success=0.8700',
    'fig15_n16_pv0': 'dev=0.1147;success=1.0000',
    'fig15_n16_pv10': 'dev=0.1148;success=1.0000',
    'fig15_n16_pv20': 'dev=0.1147;success=1.0000',
    'fig15_n16_pv30': 'dev=0.1149;success=1.0000',
    'fig15_n16_pv40': 'dev=0.1148;success=0.9998',
    'fig15_n32_pv0': 'dev=0.1323;success=1.0000',
    'fig15_n32_pv10': 'dev=0.1323;success=1.0000',
    'fig15_n32_pv20': 'dev=0.1324;success=1.0000',
    'fig15_n32_pv30': 'dev=0.1320;success=1.0000',
    'fig15_n32_pv40': 'dev=0.1326;success=1.0000',
    'fig15_dev_gain_32_over_4': 'gain=+1.5905',
    'fig16_M_and_maj5': 'speedup=1.387', 'fig16_M_and_maj7': 'speedup=1.387',
    'fig16_M_or_maj5': 'speedup=1.387', 'fig16_M_or_maj7': 'speedup=1.387',
    'fig16_M_xor_maj5': 'speedup=1.249', 'fig16_M_xor_maj7': 'speedup=1.249',
    'fig16_M_add_maj5': 'speedup=2.612', 'fig16_M_add_maj7': 'speedup=3.547',
    'fig16_M_sub_maj5': 'speedup=2.753', 'fig16_M_sub_maj7': 'speedup=2.751',
    'fig16_M_mul_maj5': 'speedup=1.490', 'fig16_M_mul_maj7': 'speedup=2.953',
    'fig16_M_div_maj5': 'speedup=2.052', 'fig16_M_div_maj7': 'speedup=2.051',
    'fig16_M_avg_maj5': 'speedup=1.847', 'fig16_M_avg_maj7': 'speedup=2.189',
    'fig16_H_and_maj5': 'speedup=1.052', 'fig16_H_and_maj7': 'speedup=1.052',
    'fig16_H_and_maj9': 'speedup=1.052', 'fig16_H_or_maj5': 'speedup=1.052',
    'fig16_H_or_maj7': 'speedup=1.052', 'fig16_H_or_maj9': 'speedup=1.052',
    'fig16_H_xor_maj5': 'speedup=1.033', 'fig16_H_xor_maj7': 'speedup=1.033',
    'fig16_H_xor_maj9': 'speedup=1.033', 'fig16_H_add_maj5': 'speedup=2.142',
    'fig16_H_add_maj7': 'speedup=2.898', 'fig16_H_add_maj9': 'speedup=0.643',
    'fig16_H_sub_maj5': 'speedup=2.312', 'fig16_H_sub_maj7': 'speedup=2.306',
    'fig16_H_sub_maj9': 'speedup=0.744', 'fig16_H_mul_maj5': 'speedup=1.213',
    'fig16_H_mul_maj7': 'speedup=2.367', 'fig16_H_mul_maj9': 'speedup=0.364',
    'fig16_H_div_maj5': 'speedup=1.716', 'fig16_H_div_maj7': 'speedup=1.714',
    'fig16_H_div_maj9': 'speedup=1.034', 'fig16_H_avg_maj5': 'speedup=1.503',
    'fig16_H_avg_maj7': 'speedup=1.775', 'fig16_H_avg_maj9': 'speedup=0.846',
    'fig17_mrc2': 'speedup=0.67', 'fig17_mrc4': 'speedup=2.02',
    'fig17_mrc8': 'speedup=4.71', 'fig17_mrc16': 'speedup=10.09',
    'fig17_mrc32': 'speedup=20.83', 'fig17_frac': 'speedup=2.76',
    'fig17_rowclone': 'speedup=1.00', 'fig18_add32_per_op': 'dispatches=64',
    'fig18_add32_fused': 'dispatches=34',
    'fig18_add32_megakernel': 'dispatches=1',
    'fig18_add32_pud_dram': 'energy_nj=112972.1', 'fig18_add32_savings': None,
    'fig18_mul8_per_op': 'dispatches=1584',
    'fig18_mul8_fused': 'dispatches=1429',
    'fig18_mul8_megakernel': 'dispatches=1',
    'fig18_mul8_pud_dram': 'energy_nj=2481557.1', 'fig18_mul8_savings': None,
    'fig18_dispatch_energy_nj': None,
    'table1_H_M': 'chips=56;density=4Gb;subarrays=(512, 640)',
    'table1_H_A': 'chips=40;density=4Gb;subarrays=(512,)',
    'table1_M_E': 'chips=16;density=16Gb;subarrays=(1024,)',
    'table1_M_B': 'chips=8;density=16Gb;subarrays=(1024,)',
    'kernel_majx9_64x2048[cuda]': None,
    'kernel_bitserial_add_32x16x512[cuda]': None,
    'kernel_fanout31_8x4096[cuda]': None,
    'kernel_mismatch_1M_cells[cuda]': None,
    'kernel_majx5_batch4_16x512[cuda]': None,
}


def run_captured(fn, *args, **kw) -> str:
    """``fn(*args, **kw)``'s standard output (also echoed to stderr)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    sys.stderr.write(out.getvalue())
    return out.getvalue()


def phase_paper(torch, kernel_mods) -> dict:
    """``python -m repro_torch.paper.run`` in process on the card (a
    fresh sweep root, no dry-run file), its rows held to the frozen
    ones, each figure timed; then the five examples' ``main``."""
    import tempfile

    from repro_torch.backends.cuda import CudaBackend
    from repro_torch.examples import (pud_arithmetic, quickstart,
                                      serve_batch, tmr_checkpoint_demo,
                                      train_tiny_lm)
    from repro_torch.paper import figures, kernel_bench, run

    t_phase = time.perf_counter()
    fig_walls = {}

    def timed_fig(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            fig_walls[fn.__name__] = time.perf_counter() - t0
            return out
        call.__name__ = fn.__name__
        return call

    zero_launches(kernel_mods)
    dispatches = []
    undo = [count_calls(CudaBackend, "_launch", dispatches)]
    saved = figures.FIGURES, kernel_bench.kernel_benchmarks
    figures.FIGURES = tuple(timed_fig(fn) for fn in saved[0])
    kernel_bench.kernel_benchmarks = timed_fig(saved[1])
    try:
        with tempfile.TemporaryDirectory(prefix="paper") as d:
            csv = run_captured(run.main, ["--device", DEVICE, "--root",
                                          os.path.join(d, "sweeps"),
                                          "--results", d])
        lines = csv.splitlines()
        check(lines[0] == "name,us_per_call,derived",
              f"paper: header {lines[0]!r}")
        rows = [ln.split(",", 2) for ln in lines[1:]]
        check([r[0] for r in rows] == list(PAPER_ROWS),
              f"paper: row names {[r[0] for r in rows][:8]}... are not "
              f"the frozen {len(PAPER_ROWS)}")
        wrong = [(n, d, PAPER_ROWS[n]) for n, _, d in rows
                 if paper_frozen(n, d) != PAPER_ROWS[n]]
        check(not wrong, f"paper: rows off their frozen values: {wrong[:5]}")
        kernels_rows = {n: {"us": float(us), "derived": d}
                        for n, us, d in rows if n.startswith("kernel_")}
        emit({"phase": "paper", "rows": len(rows),
              "frozen_equal": sum(v is not None
                                  for v in PAPER_ROWS.values()),
              "kernel_bench": kernels_rows, "figure_walls_s": fig_walls})
        progress("paper printer", t_phase)

        examples = {}
        for mod, argv, want in (
                (quickstart, (), ("quickstart OK",)),
                (pud_arithmetic, (), ("Mfr H MAJ9: avg 0.85x",)),
                (serve_batch, (), ("param integrity 100.0000%",
                                   "[serve] 8 requests, 96 new tokens")),
                (tmr_checkpoint_demo, (), (
                    "healed 1 replica(s), bit-exact=True",
                    "post-scrub restore: 0 unhealthy")),
                (train_tiny_lm, PAPER_TRAIN_ARGV, (
                    "FAILURE: node_loss at step 7", "[example] loss:"))):
            name = mod.__name__.rsplit(".", 1)[-1]
            t0 = time.perf_counter()
            out = run_captured(mod.main, [*argv, "--device", DEVICE])
            examples[name] = time.perf_counter() - t0
            check(all(w in out for w in want) and "False" not in out,
                  f"paper: {name} printed {out[-600:]}")
    finally:
        figures.FIGURES, kernel_bench.kernel_benchmarks = saved
        for u in undo:
            u()
    launches = read_launches(kernel_mods, tuple(kernel_mods),
                             len(dispatches), "paper")
    emit({"phase": "paper", "example_walls_s": examples,
          "wall_s": time.perf_counter() - t_phase})
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
    serve = timed("serve", phase_serve, torch, kernel_mods, timer)
    tmr = timed("tmr_ckpt", phase_tmr_ckpt, torch, kernel_mods)
    sweep = timed("sweep", phase_sweep, torch, kernel_mods)
    sweep_ft = timed("sweep_ft", phase_sweep_ft, torch, kernel_mods)
    lm = timed("lm_serve", phase_lm_serve, torch, kernel_mods, timer)
    train = timed("train", phase_train, torch, kernel_mods)
    zero_launches(kernel_mods)
    timed("dryrun", phase_dryrun)
    dryrun = read_launches(kernel_mods, (), 0, "dryrun")
    paper = timed("paper", phase_paper, torch, kernel_mods)
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
            "launches": (path[name] + session[name] + arith[name]
                         + serve[name] + tmr[name] + sweep[name]
                         + sweep_ft[name] + lm[name] + train[name]
                         + dryrun[name] + paper[name]),
            "launches_by_path": {"path": path[name],
                                 "session": session[name],
                                 "arith": arith[name],
                                 "serve": serve[name],
                                 "tmr_ckpt": tmr[name],
                                 "sweep": sweep[name],
                                 "sweep_ft": sweep_ft[name],
                                 "lm_serve": lm[name],
                                 "train": train[name],
                                 "dryrun": dryrun[name],
                                 "paper": paper[name]},
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
