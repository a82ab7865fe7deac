"""Row-lifetime analysis: intervals, dead ops, leaks, use-after-free.

A PUD program's rows are a manually-managed resource — the §8.1 traces
stream through dozens of SSA scratch rows, serve tenants draw on
bounded :class:`~repro_torch.session.rows.RowAllocator` arenas, and nothing
until now reported which rows a compiled artifact actually *uses*.
This pass computes per-row lifetime intervals over the op stream:

``first_write`` / ``last_write`` / ``first_read`` / ``last_read`` per
row (op indices), from which it derives

* **dead ops** — value-affecting ops none of whose written rows are
  ever read afterwards nor listed in ``outputs`` (warning: the
  executors deliberately still run them, but a compiled artifact full
  of dead votes is paying activations for nothing);
* **inferred inputs** — rows read before any write hold initial-state
  values; with an explicit ``inputs`` set, reading an undeclared row
  before writing it is an **error** (the SSA tracers declare exactly
  their bound input rows);
* **allocator audit** (:func:`allocator_findings`) — references to
  rows sitting on a :class:`~repro_torch.session.rows.RowAllocator` free
  list are use-after-free **errors** (a freed index will be handed to
  the next reservation — the cross-tenant aliasing bug class), refs
  past the high-water mark are errors, and in-use rows the program
  never touches are leak warnings.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, TYPE_CHECKING

from repro_torch.analyze.report import ERROR, WARNING, Finding
from repro_torch.pud.isa import Program

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids layer cycle
    from repro_torch.session.rows import RowAllocator


@dataclasses.dataclass
class RowLifetime:
    """Op-index interval of one row's activity (None = never)."""

    row: int
    first_write: Optional[int] = None
    last_write: Optional[int] = None
    first_read: Optional[int] = None
    last_read: Optional[int] = None

    @property
    def used(self) -> bool:
        return self.first_write is not None or self.first_read is not None

    @property
    def read_before_write(self) -> bool:
        """True when the row's initial value is observed."""
        if self.first_read is None:
            return False
        return self.first_write is None or self.first_read < self.first_write


#: Value-neutral kinds: they disturb cells / record cost but never
#: change a row's logical value, so they are invisible to dataflow.
_NEUTRAL_KINDS = ("FRAC", "WR", "RD")


def lifetimes(program: Program) -> dict[int, RowLifetime]:
    """Per-row lifetime intervals over the addressed op stream.

    Only value-affecting addressed ops register: a FRAC disturb
    "write" must not mask a genuine read-before-write on the same row.
    """
    lt: dict[int, RowLifetime] = {}

    def _at(r: int) -> RowLifetime:
        if r not in lt:
            lt[r] = RowLifetime(r)
        return lt[r]

    for i, op in enumerate(program.ops):
        if not op.dsts or op.kind in _NEUTRAL_KINDS:
            continue
        for s in op.srcs:
            row = _at(s)
            if row.first_read is None:
                row.first_read = i
            row.last_read = i
        for d in op.dsts:
            row = _at(d)
            if row.first_write is None:
                row.first_write = i
            row.last_write = i
    return lt


def liveness_findings(program: Program, *,
                      inputs: Optional[Iterable[int]] = None,
                      outputs: Optional[Iterable[int]] = None,
                      where: str = "program") -> list[Finding]:
    """Dead ops and initial-state reads (see module docstring)."""
    out: list[Finding] = []
    lt = lifetimes(program)
    out_rows = set(outputs) if outputs is not None else None
    in_rows = set(inputs) if inputs is not None else None

    for i, op in enumerate(program.ops):
        if not op.dsts or op.kind in _NEUTRAL_KINDS:
            continue
        live = False
        for d in op.dsts:
            row = lt[d]
            if row.last_read is not None and row.last_read > i:
                live = True       # someone reads this row later
            elif row.last_write == i and (out_rows is None
                                          or d in out_rows):
                # Last writer of the row: live unless the caller gave
                # an explicit output set that excludes it.  Without
                # outputs, final state is compared wholesale (the
                # differential suites), so last writes count as live.
                live = True
            if live:
                break
        if not live:
            tag = f", tag {op.tag!r}" if op.tag else ""
            out.append(Finding(
                "liveness", WARNING, "LIVE_DEAD_OP",
                f"{where}: op[{i}] {op.kind}{tag} writes row(s) "
                f"{list(op.dsts)} that nothing reads afterwards",
                where=f"op[{i}]"))

    for r in sorted(lt):
        row = lt[r]
        if not row.read_before_write:
            continue
        if in_rows is not None and r not in in_rows:
            out.append(Finding(
                "liveness", ERROR, "LIVE_UNDECLARED_INPUT",
                f"{where}: row {r} is read (op[{row.first_read}]) "
                f"before any write but is not a declared input row",
                where=f"row {r}"))
    return out


def allocator_findings(program: Program, allocator: "RowAllocator", *,
                       where: str = "program") -> list[Finding]:
    """Audit a program against the allocator that owns its row space.

    Catches the handle-lifecycle bugs the serve layer's tenant arenas
    are exposed to: an op referencing a *freed* row (use-after-free —
    that index will alias the next reservation), references past the
    allocator's high-water mark, and reserved rows the program never
    touches (leaks against a bounded arena budget).
    """
    out: list[Finding] = []
    freed = set(allocator.free_rows)
    high = allocator.n_rows
    referenced: set[int] = set()
    for i, op in enumerate(program.ops):
        if not op.dsts:
            continue
        for r in (*op.srcs, *op.dsts):
            referenced.add(r)
            if r in freed:
                out.append(Finding(
                    "liveness", ERROR, "LIVE_USE_AFTER_FREE",
                    f"{where}: op[{i}] {op.kind} references row {r}, "
                    f"which sits on {allocator.name}'s free list — a "
                    f"later reservation will alias it",
                    where=f"op[{i}]"))
            elif r >= high:
                out.append(Finding(
                    "liveness", ERROR, "LIVE_UNALLOCATED",
                    f"{where}: op[{i}] {op.kind} references row {r}, "
                    f"past {allocator.name}'s high-water mark "
                    f"({high} rows allocated)", where=f"op[{i}]"))
    leaked = sorted(set(range(high)) - freed - referenced)
    if leaked:
        out.append(Finding(
            "liveness", WARNING, "LIVE_LEAKED_ROWS",
            f"{where}: {len(leaked)} reserved row(s) never referenced "
            f"by the program (e.g. {leaked[:8]}) — still charged "
            f"against {allocator.name}'s budget"))
    return out
