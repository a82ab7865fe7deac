"""Program-fusion scheduler: dependency levels -> batched dispatch groups.

The per-op interpreter (:meth:`repro_torch.backends.base.Backend.run`) launches
one kernel per MAJ/MRC op, so a 32-bit ripple-carry adder costs ~100 tiny
dispatches.  PULSAR-style, the win comes from amortizing command overhead
across many simultaneously issued operations: this module partitions an
addressed :class:`~repro_torch.pud.isa.Program` into *dependency levels* — maximal
sets of ops that can execute against the same entry state — and fuses each
level into at most one MAJX dispatch plus at most one Multi-RowCopy
dispatch.  The ``cuda`` backend's :meth:`run_fused` walks the schedule;
per-op and fused execution are bit-identical by construction.

Hazard model (reads sample the level-entry state, writes commit at level
exit):

* **RAW** — an op reading row ``r`` is placed strictly after the level
  that last wrote ``r``;
* **WAW** — two writers of the same row land in different levels, so no
  level scatters twice into one row;
* **WAR** — a writer may share a level with *earlier* readers of its
  destination (they read the entry state, matching program order), but a
  reader that follows the writer in program order is pushed later by RAW.

Destination-aliasing programs (an op whose ``dsts`` intersect its
``srcs``, or rows rewritten many times) therefore schedule correctly.

Mixed-arity MAJ fusion uses the exact padding identity

    ``MAJ_k(x_1..x_k) == MAJ_{k+2m}(x_1..x_k, 0 * m, 1 * m)``

(each constant 0/1 *pair* adds one to the popcount and one to the
majority threshold), so one batched kernel launch serves every arity in
a level; the constant planes are synthesized by the executor, never
materialized as state rows.
"""

from __future__ import annotations

import dataclasses

from repro_torch.pud.isa import Program, PUDOp

#: Op kinds that change the (rows, words) image.  FRAC initializes rows
#: to the neutral charge state (value-wise a no-op on every backend), and
#: WR/RD are I/O accounting ops, so none of them schedule.
VALUE_KINDS = ("MAJ", "NOT", "COPY", "MRC")


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """Ops of one kind inside one level, executed as a single batch.

    ``param`` is the batch-shape parameter: the widest MAJ arity in the
    group (narrower ops are padded with 0/1 plane pairs) or the widest
    MRC fan-out (ops with fewer destinations scatter a prefix of the
    copies).  NOT/COPY groups are pure gather/scatter (no kernel).
    """

    kind: str
    param: int
    ops: tuple[PUDOp, ...]

    @property
    def is_dispatch(self) -> bool:
        """True when executing this group costs one kernel launch."""
        return self.kind in ("MAJ", "MRC")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A leveled, batched execution plan for one Program."""

    levels: tuple[tuple[FusedGroup, ...], ...]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def n_dispatches(self) -> int:
        """Kernel launches the fused executor will issue."""
        return sum(1 for lvl in self.levels for g in lvl if g.is_dispatch)

    def per_op_dispatches(self) -> int:
        """Kernel launches the per-op interpreter issues for the same ops."""
        return sum(len(g.ops) for lvl in self.levels
                   for g in lvl if g.is_dispatch)

    def histogram(self) -> dict[tuple, int]:
        """(kind, param) -> group count, for structural assertions."""
        h: dict[tuple, int] = {}
        for lvl in self.levels:
            for g in lvl:
                h[(g.kind, g.param)] = h.get((g.kind, g.param), 0) + 1
        return h


def _schedulable(op: PUDOp) -> bool:
    if not op.dsts:
        return False  # cost-only record: nothing addressable to do
    if op.kind in ("FRAC", "WR", "RD"):
        return False  # value-wise no-ops (see VALUE_KINDS)
    if op.kind not in VALUE_KINDS:
        raise ValueError(f"unknown op kind {op.kind}")
    return True


def dependency_levels(program: Program) -> list[list[PUDOp]]:
    """Partition value-affecting ops into hazard-respecting levels.

    Greedy list scheduling in program order: each op lands on the
    earliest level satisfying the RAW/WAW/WAR constraints in the module
    docstring.  Dead ops (results never read) still schedule — they
    write state the differential tests compare.
    """
    write_level: dict[int, int] = {}   # row -> level of its last writer
    read_level: dict[int, int] = {}    # row -> latest level that read it
    levels: list[list[PUDOp]] = []
    for op in program.ops:
        if not _schedulable(op):
            continue
        lvl = 0
        for s in op.srcs:
            if s in write_level:               # RAW: read strictly after
                lvl = max(lvl, write_level[s] + 1)
        for d in op.dsts:
            if d in write_level:               # WAW: one writer per level
                lvl = max(lvl, write_level[d] + 1)
            if d in read_level:                # WAR: share level with
                lvl = max(lvl, read_level[d])  # earlier readers only
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(op)
        for s in op.srcs:
            read_level[s] = max(read_level.get(s, 0), lvl)
        for d in op.dsts:
            write_level[d] = lvl
    return levels


def build_schedule(program: Program) -> Schedule:
    """Level the program and fuse each level into dispatch groups.

    Per level: all MAJ ops form one group (padded to the widest arity),
    all MRC ops one group (padded to the widest fan-out), NOT and COPY
    one gather/scatter group each.  Group order inside a level is fixed
    (MAJ, MRC, NOT, COPY) but irrelevant to semantics: WAW leveling
    guarantees disjoint destination rows within a level, and every group
    reads the level-entry state.
    """
    out: list[tuple[FusedGroup, ...]] = []
    for ops in dependency_levels(program):
        groups: list[FusedGroup] = []
        for kind in VALUE_KINDS:
            members = tuple(op for op in ops if op.kind == kind)
            if not members:
                continue
            if kind == "MAJ":
                param = max(len(op.srcs) for op in members)
            elif kind == "MRC":
                param = max(len(op.dsts) for op in members)
            else:
                param = 0
            groups.append(FusedGroup(kind, param, members))
        out.append(tuple(groups))
    return Schedule(tuple(out))
