"""SessionProgram: record PUD ops against typed row handles.

The builder is the session-level replacement for hand-emitting
:class:`~repro_torch.pud.isa.PUDOp` streams with integer addresses: operands
and destinations are :class:`~repro_torch.session.rows.Row` /
:class:`~repro_torch.session.rows.PlaneGroup` handles from the builder's own
allocator, every op is validated as it is recorded (arity, ownership,
duplicate destinations), and activation counts default from the
session's :class:`~repro_torch.backends.context.ExecutionContext` through the
§4 reachable-level ladder — the same defaulting the §8.1 ``BitSerial``
compiler applies.

``input(planes)`` binds initial row values, so the builder can also
materialize the ``(rows, words)`` image the program executes against
(:meth:`initial_state`), and :meth:`run` hands both to the owning
:class:`~repro_torch.session.DramSession` — compile cache included.
"""

from __future__ import annotations

import collections
from typing import Optional, Union

import numpy as np

from repro_torch.core import calibration as cal
from repro_torch.pud.isa import Program
from repro_torch.session.rows import (PlaneGroup, Row, RowAllocator,
                                      SessionError)
from repro_torch.session.validate import check_program


class SessionProgram:
    """A typed program under construction (see module docstring).

    ``rows`` caps the subarray row budget (allocation past it raises
    with the budget in the message); ``None`` lets the image grow to
    whatever the program needs.
    """

    def __init__(self, session, rows: Optional[int] = None,
                 name: str = "session-program"):
        self._session = session
        self.name = name
        self.alloc = RowAllocator(rows, name=name)
        self.program = Program()
        self._bound: dict[int, np.ndarray] = {}
        self._width: Optional[int] = None

    # ------------------------------------------------------------- rows
    def alloc_row(self, tag: str = "") -> Row:
        return self.alloc.alloc_row(tag=tag)

    def alloc_rows(self, n: int, tag: str = "") -> PlaneGroup:
        return self.alloc.alloc(n, tag=tag)

    def input(self, planes, tag: str = "input"
              ) -> Union[Row, PlaneGroup]:
        """Allocate row(s) holding initial values.

        ``planes``: (words,) for one row -> :class:`Row`;
        (rows, words) -> :class:`PlaneGroup`.  The bound values build
        :meth:`initial_state`.
        """
        arr = np.asarray(planes, np.uint32)
        if arr.ndim not in (1, 2):
            raise SessionError(
                f"{self.name}: input planes must be (words,) or "
                f"(rows, words), got shape {arr.shape}")
        width = int(arr.shape[-1])
        if self._width is not None and width != self._width:
            raise SessionError(
                f"{self.name}: input row width {width} != bound "
                f"width {self._width} (one subarray, one row width)")
        self._width = width
        if arr.ndim == 1:
            row = self.alloc.alloc_row(tag=tag)
            self._bound[row.index] = arr
            return row
        group = self.alloc.alloc(arr.shape[0], tag=tag)
        for row, vals in zip(group, arr):
            self._bound[row.index] = vals
        return group

    def _own(self, row, what: str) -> Row:
        if not isinstance(row, Row):
            raise SessionError(
                f"{self.name}: {what} must be a Row handle (from "
                f".alloc_row()/.input()), got {type(row).__name__}")
        if not self.alloc.owns(row):
            raise SessionError(
                f"{self.name}: {what} row {row.index} (tag "
                f"{row.tag!r}) belongs to a different program — row "
                f"handles cannot alias across subarray images")
        return row

    def _n_act(self, n_act: Optional[int], floor: int) -> int:
        return cal.min_activation_for(
            max(n_act or self._session.ctx.n_act, floor))

    # -------------------------------------------------------------- ops
    def maj(self, *srcs: Row, dst: Optional[Row] = None,
            n_act: Optional[int] = None, tag: str = "maj") -> Row:
        """MAJ over the operand rows (duplicates = input replication).

        Allocates ``dst`` when not given; ``n_act`` defaults to the
        session context's count, raised to the smallest reachable
        activation level holding the arity.
        """
        x = len(srcs)
        if x % 2 == 0 or x < 3:
            raise SessionError(
                f"{self.name}: MAJ arity must be odd >= 3, got {x} "
                f"(tag {tag!r})")
        srcs = tuple(self._own(s, "MAJ operand") for s in srcs)
        dst = self._own(dst, "MAJ destination") if dst is not None \
            else self.alloc.alloc_row(tag=tag)
        self.program.emit("MAJ", x=x, n_act=self._n_act(n_act, x),
                          tag=tag, srcs=tuple(s.index for s in srcs),
                          dsts=(dst.index,))
        return dst

    def mrc(self, src: Row, dsts: Union[int, PlaneGroup],
            n_act: Optional[int] = None, tag: str = "mrc") -> PlaneGroup:
        """Multi-RowCopy ``src`` to ``dsts`` (a fan-out count or group)."""
        src = self._own(src, "MRC source")
        if isinstance(dsts, int):
            dsts = self.alloc.alloc(dsts, tag=tag)
        group = PlaneGroup(tuple(
            self._own(d, "MRC destination") for d in dsts))
        dup = sorted(r for r, c in collections.Counter(group.indices).items()
                     if c > 1)
        if dup:
            raise SessionError(
                f"{self.name}: MRC (tag {tag!r}) writes destination "
                f"row(s) {dup} more than once in a single op")
        # MRC activates source + fan-out rows together: default to the
        # smallest reachable level covering them (ctx.n_act is the MAJ
        # replication knob, not a copy fan-out).
        self.program.emit(
            "MRC", n_act=cal.min_activation_for(
                max(n_act or 0, len(group) + 1)),
            tag=tag, srcs=(src.index,), dsts=group.indices)
        return group

    def not_(self, src: Row, dst: Optional[Row] = None,
             tag: str = "not") -> Row:
        return self._unary("NOT", src, dst, tag)

    def copy(self, src: Row, dst: Optional[Row] = None,
             tag: str = "copy") -> Row:
        return self._unary("COPY", src, dst, tag)

    def _unary(self, kind: str, src: Row, dst: Optional[Row],
               tag: str) -> Row:
        src = self._own(src, f"{kind} source")
        dst = self._own(dst, f"{kind} destination") if dst is not None \
            else self.alloc.alloc_row(tag=tag)
        self.program.emit(kind, tag=tag, srcs=(src.index,),
                          dsts=(dst.index,))
        return dst

    # -------------------------------------------------------- finishing
    def build(self) -> Program:
        """Validate the whole recorded stream and return the Program."""
        check_program(self.program, self.alloc.n_rows, where=self.name)
        return self.program

    def initial_state(self, width: Optional[int] = None) -> np.ndarray:
        """(rows, words) uint32 image: bound inputs hold their values,
        scratch/output rows start zeroed."""
        w = width or self._width
        if w is None:
            raise SessionError(
                f"{self.name}: no input rows bound; pass width= to "
                f"size the subarray image")
        state = np.zeros((self.alloc.n_rows, w), np.uint32)
        for idx, vals in self._bound.items():
            state[idx] = vals
        return state

    def run(self, state=None, fused: bool = True):
        """Build, then execute on the owning session (compile-cached)."""
        prog = self.build()
        if state is None:
            state = self.initial_state()
        run = self._session.run_fused if fused else self._session.run
        return run(prog, state)
