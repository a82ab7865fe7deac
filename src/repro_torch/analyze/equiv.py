"""Dataflow-equivalence certification by symbolic execution.

The differential suites sample random programs; this pass *proves* a
specific compiled artifact.  All three execution forms of a program —
the sequential op stream, the hazard-leveled
:class:`~repro_torch.compile.schedule.Schedule`, and the megakernel
:class:`~repro_torch.compile.megakernel.MegaLowering` slot tables — are
symbolically executed over an abstract dataflow domain, and the final
per-row values must be *structurally identical* terms.

The domain is a hash-consed term algebra:

* ``Input(r)`` — row ``r``'s initial-state value,
* ``Const0`` / ``Const1`` — the all-zero / all-one planes,
* ``Not(v)`` — bitwise complement, with ``Not(Not(v)) = v`` and
  constant folding,
* ``Maj(v_1..v_k)`` — bit-position majority, canonicalized by operand
  *sort* (majority is symmetric; duplicates are preserved — input
  replication is semantically meaningful), with two sound rewrites:

  - **arity-padding cancellation**: matched (Const0, Const1) operand
    pairs are removed — the exact
    ``MAJ_k == MAJ_{k+2m}(.., 0*m, 1*m)`` identity the fused and
    megakernel paths rely on (each pair adds one to the popcount and
    one to the threshold);
  - **identity collapse**: a 1-ary majority is its operand (how the
    MRC/COPY/NOT arity-1 expansion slots certify), and an all-constant
    majority folds to its constant.

Every rewrite is a true identity of the concrete semantics, so equal
normal forms imply bit-equal execution on every backend; the rewrites
are exactly the transformations the compiler performs, so the correct
compiler output always normalizes back onto the source program's terms
— any surviving structural difference is a genuine compilation bug
(or an injected mutation: see :mod:`repro_torch.analyze.mutate`).

Hazard semantics match the executors: schedule and table execution
read the *level-entry* state and commit writes at level exit, while
the sequential reference commits op by op.  A leveling bug therefore
shows up as a term mismatch here even if the race pass missed it.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analyze.report import ERROR, Finding
from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW, ZERO_ROW)
from repro_torch.compile.schedule import Schedule
from repro_torch.pud.isa import Program

_SKIP_KINDS = ("FRAC", "WR", "RD")


class SymbolicDomain:
    """Hash-consed term interner: structural equality is id equality."""

    def __init__(self):
        self._ids: dict[tuple, int] = {}
        self._terms: list[tuple] = []
        self.const0 = self._intern(("const", 0))
        self.const1 = self._intern(("const", 1))

    def _intern(self, key: tuple) -> int:
        vid = self._ids.get(key)
        if vid is None:
            vid = len(self._terms)
            self._ids[key] = vid
            self._terms.append(key)
        return vid

    # ----------------------------------------------------- constructors
    def input(self, row: int) -> int:
        return self._intern(("in", row))

    def not_(self, v: int) -> int:
        if v == self.const0:
            return self.const1
        if v == self.const1:
            return self.const0
        term = self._terms[v]
        if term[0] == "not":
            return term[1]           # Not(Not(v)) = v
        return self._intern(("not", v))

    def maj(self, operands: tuple[int, ...]) -> int:
        """Canonical majority term (see module docstring rewrites)."""
        ops = list(operands)
        # Arity-padding cancellation: drop matched (0, 1) pairs.
        pairs = min(ops.count(self.const0), ops.count(self.const1))
        for _ in range(pairs):
            ops.remove(self.const0)
            ops.remove(self.const1)
        if not ops:
            raise ValueError("majority over zero operands")
        if len(ops) == 1:
            return ops[0]            # MAJ_1(v) = v (identity slots)
        consts = {self.const0, self.const1}
        if all(o in consts for o in ops):
            ones = sum(1 for o in ops if o == self.const1)
            return self.const1 if 2 * ones > len(ops) else self.const0
        return self._intern(("maj", tuple(sorted(ops))))

    def render(self, v: int, depth: int = 3) -> str:
        """Short human form of a term, for finding messages."""
        kind, *rest = self._terms[v]
        if kind == "const":
            return str(rest[0])
        if kind == "in":
            return f"in[{rest[0]}]"
        if depth <= 0:
            return "..."
        if kind == "not":
            return f"~{self.render(rest[0], depth - 1)}"
        args = ", ".join(self.render(o, depth - 1) for o in rest[0][:5])
        more = ", ..." if len(rest[0]) > 5 else ""
        return f"maj({args}{more})"


def _apply_op(dom: SymbolicDomain, op, read) -> Optional[int]:
    """The value an op writes to every destination, reading via ``read``."""
    if not op.dsts or op.kind in _SKIP_KINDS:
        return None
    if op.kind == "MAJ":
        return dom.maj(tuple(read(s) for s in op.srcs))
    if op.kind == "NOT":
        return dom.not_(read(op.srcs[0]))
    if op.kind in ("COPY", "MRC"):
        return read(op.srcs[0])
    return None  # unknown kinds are reported by the race pass


def exec_program(dom: SymbolicDomain, program: Program,
                 n_rows: Optional[int] = None) -> list[int]:
    """Sequential symbolic execution — the reference dataflow."""
    n = n_rows if n_rows is not None else program.n_rows()
    state = [dom.input(r) for r in range(n)]
    for op in program.ops:
        v = _apply_op(dom, op, lambda s: state[s])
        if v is None:
            continue
        for d in op.dsts:
            state[d] = v
    return state


def exec_schedule(dom: SymbolicDomain, sched: Schedule,
                  n_rows: int) -> list[int]:
    """Level-at-a-time execution: entry-state reads, exit commits."""
    state = [dom.input(r) for r in range(n_rows)]
    for lvl in sched.levels:
        entry = list(state)
        for g in lvl:
            for op in g.ops:
                v = _apply_op(dom, op, lambda s: entry[s])
                if v is None:
                    continue
                for d in op.dsts:
                    state[d] = v
    return state


def exec_lowering(dom: SymbolicDomain, low: MegaLowering) -> list[int]:
    """Slot-table execution over the augmented (const-prefixed) image.

    Returns the augmented row values; program row ``r`` lives at index
    ``r + N_CONST_ROWS``.  The trash row participates (inert slots
    write it) but is excluded from comparison by the caller.
    """
    state = [dom.const0, dom.const1, dom.const0]   # zero / one / trash
    state += [dom.input(r) for r in range(low.n_rows)]
    # Python lists: one conversion, not a numpy scalar read per slot.
    srcs, dsts, invs = low.src.tolist(), low.dst.tolist(), low.inv.tolist()
    # dom.maj is a function of its operands (its first call interns the
    # term), so the padded slots' repeated constant votes are looked up.
    votes: dict[tuple[int, ...], int] = {}
    for li in range(low.n_levels):
        entry = list(state)
        for w in range(low.w_max):
            operands = tuple(entry[r] for r in srcs[li][w])
            v = votes.get(operands)
            if v is None:
                v = votes[operands] = dom.maj(operands)
            if invs[li][w]:
                v = dom.not_(v)
            state[dsts[li][w]] = v
    return state


def equivalence_findings(program: Program, sched: Optional[Schedule] = None,
                         lowering: Optional[MegaLowering] = None, *,
                         where: str = "program") -> list[Finding]:
    """Prove schedule / lowering dataflow equal to the source program.

    One shared :class:`SymbolicDomain` interns all three executions, so
    comparison is integer equality per row.  Findings carry rendered
    terms for the first few mismatching rows.
    """
    out: list[Finding] = []
    dom = SymbolicDomain()
    n_rows = program.n_rows()
    ref = exec_program(dom, program, n_rows)

    if sched is not None:
        got = exec_schedule(dom, sched, n_rows)
        for r in range(n_rows):
            if got[r] != ref[r]:
                out.append(Finding(
                    "equivalence", ERROR, "EQ_SCHEDULE_ROW",
                    f"{where}: schedule computes row {r} = "
                    f"{dom.render(got[r])}, program computes "
                    f"{dom.render(ref[r])}", where=f"row {r}"))

    if lowering is not None:
        if lowering.n_rows != n_rows:
            out.append(Finding(
                "equivalence", ERROR, "EQ_TABLE_SHAPE",
                f"{where}: lowering covers {lowering.n_rows} program "
                f"rows, program addresses {n_rows}"))
            return out
        aug = exec_lowering(dom, lowering)
        if aug[ZERO_ROW] != dom.const0 or aug[ONE_ROW] != dom.const1:
            out.append(Finding(
                "equivalence", ERROR, "EQ_CONST_CLOBBERED",
                f"{where}: a slot overwrote the constant 0/1 rows — "
                f"every later padded vote is corrupted"))
        for r in range(n_rows):
            if aug[r + N_CONST_ROWS] != ref[r]:
                out.append(Finding(
                    "equivalence", ERROR, "EQ_TABLE_ROW",
                    f"{where}: level tables compute row {r} = "
                    f"{dom.render(aug[r + N_CONST_ROWS])}, program "
                    f"computes {dom.render(ref[r])}", where=f"row {r}"))
    # TRASH_ROW deliberately uncompared: it is the inert-slot sink.
    return out
