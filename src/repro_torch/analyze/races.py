"""Race detection over Programs, Schedule levels, and lowered slot tables.

The fused executors assume one hazard model — *reads sample the
level-entry state, writes commit at level exit* — and the scheduler's
leveling is what makes that model agree with sequential program order.
This pass re-derives the safety conditions from the artifacts
themselves instead of trusting the compiler:

* **Program ops** (:func:`check_ops`) — the cheap structural pass every
  :func:`repro_torch.session.validate.check_program` call runs: row addresses
  in range, no destination written twice inside one op, MAJ arity
  odd/complete, single-source kinds single-sourced.
* **Schedule levels** (:func:`schedule_findings`) — no two ops of one
  level writing the same row with different values (intra-level WAW;
  identical redundant writes, e.g. one op's duplicated destination
  list, are benign), and no op reading a row that an
  earlier-in-program-order op of the *same* level writes (intra-level
  RAW: the executor would feed it stale entry state).  WAR sharing —
  a writer leveled with earlier readers of its destination — is legal
  by the entry-state model and is not flagged.
* **Slot tables** (:func:`lowering_findings`) — per level of a
  :class:`~repro_torch.compile.megakernel.MegaLowering`: no two live slots
  writing one row (unless they compute the identical vote), no slot
  writing the front constant rows, no live slot reading the trash row,
  all indices inside the augmented image, pad parity intact.

Everything here is pure content inspection — no backend, no state — so
the checks run at compile/cache-insert time in O(ops) / O(slots).
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional

from repro_torch.analyze.report import ERROR, WARNING, Finding
from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW, TRASH_ROW, ZERO_ROW)
from repro_torch.compile.schedule import Schedule, VALUE_KINDS
from repro_torch.pud.isa import Program, PUDOp

#: Kinds that read exactly one source row when addressed.
SINGLE_SRC = ("NOT", "COPY", "MRC")

#: Every kind the ISA defines (the scheduler raises on anything else;
#: the analyzer reports instead).
KNOWN_KINDS = (*VALUE_KINDS, "FRAC", "WR", "RD")


def _schedulable(op: PUDOp) -> bool:
    """Value-affecting addressed ops — the scheduler's predicate, but
    total: unknown kinds are excluded here and flagged by
    :func:`check_ops` rather than raising mid-analysis."""
    return bool(op.dsts) and op.kind in VALUE_KINDS


def _label(i: int, op: PUDOp) -> str:
    tag = f", tag {op.tag!r}" if op.tag else ""
    return f"op[{i}] {op.kind}{tag}"


# --------------------------------------------------------- program ops


def check_ops(program: Program, n_rows: int,
              where: str = "program") -> list[Finding]:
    """The cheap per-op structural pass (validation-grade, error-level).

    This is the single source of truth behind
    :func:`repro_torch.session.validate.check_program`: the session layer
    raises on any error finding returned here, and the certifier runs
    the same pass so a hand-built Program cannot reach a backend in a
    shape the analyzer would reject.
    """
    out: list[Finding] = []
    for i, op in enumerate(program.ops):
        if op.kind not in KNOWN_KINDS:
            out.append(Finding(
                "race", ERROR, "OP_UNKNOWN_KIND",
                f"{where}: {_label(i, op)} has unknown kind "
                f"{op.kind!r}", where=f"op[{i}]"))
            continue
        if not op.dsts:
            continue  # cost-only record: nothing addressable to check
        for role, addrs in (("source", op.srcs), ("destination", op.dsts)):
            for r in addrs:
                if not 0 <= r < n_rows:
                    out.append(Finding(
                        "race", ERROR, "OP_ROW_RANGE",
                        f"{where}: {_label(i, op)} {role} row {r} is "
                        f"outside the {n_rows}-row subarray image",
                        where=f"op[{i}]"))
        dup = sorted(r for r, c in collections.Counter(op.dsts).items()
                     if c > 1)
        if dup:
            out.append(Finding(
                "race", ERROR, "OP_DUP_DST",
                f"{where}: {_label(i, op)} writes destination row(s) "
                f"{dup} more than once in a single op "
                f"({n_rows}-row subarray image)", where=f"op[{i}]"))
        if op.kind == "MAJ":
            x = op.x or len(op.srcs)
            if x % 2 == 0 or x < 3:
                out.append(Finding(
                    "race", ERROR, "OP_MAJ_ARITY",
                    f"{where}: {_label(i, op)} MAJ arity must be odd "
                    f">= 3, got {x}", where=f"op[{i}]"))
            elif len(op.srcs) != x:
                out.append(Finding(
                    "race", ERROR, "OP_MAJ_OPERANDS",
                    f"{where}: {_label(i, op)} MAJ{x} carries "
                    f"{len(op.srcs)} source rows (needs exactly {x})",
                    where=f"op[{i}]"))
            elif op.n_act and op.n_act < x:
                # Physically underpowered issue (x voting rows need at
                # least x simultaneous activations) — advisory only:
                # grid programs legitimately probe infeasible regimes.
                out.append(Finding(
                    "race", WARNING, "OP_NACT_UNDER_ARITY",
                    f"{where}: {_label(i, op)} MAJ{x} issued with "
                    f"n_act={op.n_act} < arity", where=f"op[{i}]"))
        elif op.kind in SINGLE_SRC and len(op.srcs) != 1:
            out.append(Finding(
                "race", ERROR, "OP_SRC_COUNT",
                f"{where}: {_label(i, op)} takes exactly one source "
                f"row, got {len(op.srcs)}", where=f"op[{i}]"))
    return out


# ----------------------------------------------------- schedule levels


def _value_sig(op: PUDOp) -> tuple:
    """What determines an op's written value under entry-state reads."""
    return (op.kind, op.x, op.srcs)


def iter_level_ops(sched: Schedule, program: Optional[Program] = None
                   ) -> Iterator[tuple[int, list[tuple[int, PUDOp]]]]:
    """Per level: ops annotated with their *program-order* position.

    Group order inside a level is by kind (MAJ, MRC, NOT, COPY), not
    program order, so hazard checks recover the source order from the
    Program: content-equal ops consume ascending program indices (they
    are interchangeable, so the assignment is exact for hazard
    purposes).  Without a program, falls back to schedule order.
    """
    queues: dict[PUDOp, collections.deque[int]] = {}
    if program is not None:
        by_op: dict[PUDOp, collections.deque[int]] = \
            collections.defaultdict(collections.deque)
        for i, op in enumerate(program.ops):
            if _schedulable(op):
                by_op[op].append(i)
        queues = by_op
    counter = 0
    for li, lvl in enumerate(sched.levels):
        annotated: list[tuple[int, PUDOp]] = []
        for g in lvl:
            for op in g.ops:
                if queues and queues.get(op):
                    annotated.append((queues[op].popleft(), op))
                else:
                    annotated.append((counter, op))
                counter += 1
        yield li, sorted(annotated, key=lambda t: t[0])


def schedule_findings(sched: Schedule, program: Optional[Program] = None,
                      where: str = "schedule") -> list[Finding]:
    """Intra-level WAW / RAW races plus op-set completeness vs source."""
    out: list[Finding] = []
    for li, ops in iter_level_ops(sched, program):
        written: dict[int, tuple] = {}       # row -> value signature
        writer: dict[int, int] = {}          # row -> program index
        for pi, op in ops:
            for s in op.srcs:
                if s in written:
                    out.append(Finding(
                        "race", ERROR, "RACE_RAW_LEVEL",
                        f"{where}: level {li} op (program index {pi}, "
                        f"{op.kind}) reads row {s} written earlier in "
                        f"the same level (program index {writer[s]}) — "
                        f"the fused executor would feed it stale "
                        f"level-entry state", where=f"level {li}"))
            for d in op.dsts:
                sig = _value_sig(op)
                if d in written and written[d] != sig:
                    out.append(Finding(
                        "race", ERROR, "RACE_WAW_LEVEL",
                        f"{where}: level {li} has two writers of row "
                        f"{d} with different values (program indices "
                        f"{writer[d]} and {pi}) — level-exit commit "
                        f"order is unspecified", where=f"level {li}"))
                written[d] = sig
                writer[d] = pi
    if program is not None:
        want = collections.Counter(
            op for op in program.ops if _schedulable(op))
        got = collections.Counter(
            op for lvl in sched.levels for g in lvl for op in g.ops)
        if want != got:
            missing = list((want - got).elements())[:3]
            extra = list((got - want).elements())[:3]
            out.append(Finding(
                "race", ERROR, "SCHED_OP_SET",
                f"{where}: scheduled op multiset differs from the "
                f"source program (missing {len(list((want - got).elements()))}, "
                f"extra {len(list((got - want).elements()))}; e.g. "
                f"missing={missing!r} extra={extra!r})"))
    return out


# --------------------------------------------------- lowered slot tables


def _is_inert_slot(src_row, dst: int, inv: int) -> bool:
    """The padding shape :func:`lower_schedule` emits for unused slots
    (``src_row``: the slot's operand rows, an array or a list)."""
    return (dst == TRASH_ROW and inv == 0
            and all(r == ZERO_ROW or r == ONE_ROW for r in src_row))


def lowering_findings(low: MegaLowering,
                      where: str = "lowering") -> list[Finding]:
    """Structural safety of megakernel level tables (see module doc)."""
    out: list[Finding] = []
    n_aug = low.n_rows + N_CONST_ROWS
    if low.x_max % 2 == 0:
        out.append(Finding(
            "race", ERROR, "TAB_X_PARITY",
            f"{where}: padded vote arity x_max={low.x_max} is even — "
            f"majority is undefined"))
    # Python lists: one conversion, not a numpy scalar read per slot.
    srcs, dsts, invs = low.src.tolist(), low.dst.tolist(), low.inv.tolist()
    for li in range(low.n_levels):
        writers: dict[int, tuple] = {}   # row -> (operand tuple, inv)
        for w in range(low.w_max):
            src_row, dst, inv = srcs[li][w], dsts[li][w], invs[li][w]
            if _is_inert_slot(src_row, dst, inv):
                # Padding: in range, reads only the constant rows and
                # writes only trash, so no check below can fire on it.
                continue
            here = f"level {li} / slot {w}"
            if not 0 <= dst < n_aug:
                out.append(Finding(
                    "race", ERROR, "TAB_DST_RANGE",
                    f"{where}: {here} writes row {dst}, outside the "
                    f"{n_aug}-row augmented image", where=here))
                continue
            bad_src = [int(r) for r in src_row if not 0 <= r < n_aug]
            if bad_src:
                out.append(Finding(
                    "race", ERROR, "TAB_SRC_RANGE",
                    f"{where}: {here} reads row(s) {bad_src}, outside "
                    f"the {n_aug}-row augmented image", where=here))
                continue
            if dst in (ZERO_ROW, ONE_ROW):
                out.append(Finding(
                    "race", ERROR, "RACE_CONST_WRITE",
                    f"{where}: {here} writes constant row {dst} — the "
                    f"0/1 planes every padded vote depends on",
                    where=here))
            if TRASH_ROW in src_row:
                out.append(Finding(
                    "race", ERROR, "RACE_TRASH_READ",
                    f"{where}: {here} reads the trash row "
                    f"({TRASH_ROW}) outside an inert slot — trash "
                    f"holds garbage from prior levels", where=here))
            if dst == TRASH_ROW:
                continue  # trash collects every inert write; never raced
            sig = (tuple(src_row), inv)
            if dst in writers and writers[dst] != sig:
                out.append(Finding(
                    "race", ERROR, "RACE_WAW_SLOTS",
                    f"{where}: level {li} has two slots scattering "
                    f"different votes into row {dst} — scatter order "
                    f"within a level is unspecified", where=here))
            writers[dst] = sig
    return out
