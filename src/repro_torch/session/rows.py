"""Typed subarray row handles: allocation as an API, not an integer.

The paper's programs are *compositions over subarray rows* — MAJX reads
X operand rows, Multi-RowCopy fans one row out to N destinations, the
§8.1 bit-serial programs stream through dozens of scratch rows.  Hand
-assembled integer addresses fail late (a bad index scatters into the
wrong row inside a kernel, bit-exactness silently breaks); this module
makes rows *handles* handed out by an allocator, so range and aliasing
mistakes are caught when the program is built, with the subarray context
in the message.

:class:`Row` is one subarray row; :class:`PlaneGroup` an ordered group
of rows (operand planes of a MAJX stack, destinations of a Multi-RowCopy
fan-out).  Handles remember their allocator, so an op that mixes rows
from two different programs is rejected instead of aliasing by index
coincidence.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional


class SessionError(ValueError):
    """Base error of the session layer (build-time, never kernel-side)."""


class RowAllocationError(SessionError):
    """Subarray row budget exceeded at allocation time."""


@dataclasses.dataclass(frozen=True)
class Row:
    """A handle to one subarray row.

    ``index`` is the row address an executing backend sees; ``tag`` is
    provenance for error messages and recorded ops.  Handles compare by
    (index, tag) but belong to exactly one allocator — ops validate
    ownership so handles never alias across programs.
    """

    index: int
    tag: str = ""
    allocator: Optional["RowAllocator"] = dataclasses.field(
        default=None, repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class PlaneGroup:
    """An ordered group of :class:`Row` handles.

    What MAJX operand stacks, Multi-RowCopy destination fans, and
    bound input tiles are made of.  Indexing returns a :class:`Row`
    (or a sub-:class:`PlaneGroup` for slices).
    """

    rows: tuple[Row, ...]

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[Row]:
        return iter(self.rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PlaneGroup(self.rows[i])
        return self.rows[i]

    @property
    def indices(self) -> tuple[int, ...]:
        return tuple(r.index for r in self.rows)


class RowAllocator:
    """Bump allocator (with reuse) over one subarray image's row space.

    ``capacity=None`` is unbounded (the executing image is sized by
    :meth:`n_rows` at build time); with a capacity, exceeding the row
    budget raises :class:`RowAllocationError` naming the subarray and
    the rows in use — the build-time analogue of running off the end of
    a physical subarray.

    Program builders allocate monotonically and never release, so their
    row addresses stay append-ordered.  Long-lived *arenas* (the serve
    layer's per-tenant row budgets) additionally :meth:`free` completed
    reservations: freed indices are reused by later allocations, which
    is what lets a bounded tenant budget admit an unbounded request
    stream.  Freeing invalidates the released handles — the arena owner
    must drop them; a retained stale handle aliases whichever
    reservation is handed the index next.
    """

    def __init__(self, capacity: Optional[int] = None,
                 name: str = "subarray"):
        self.capacity = capacity
        self.name = name
        self._next = 0
        self._free: list[int] = []

    @property
    def n_rows(self) -> int:
        """High-water mark == the executing image's row count."""
        return self._next

    @property
    def in_use(self) -> int:
        """Rows currently reserved (allocated and not freed)."""
        return self._next - len(self._free)

    @property
    def free_rows(self) -> tuple[int, ...]:
        """Indices currently on the free list.

        A program referencing any of these is using a stale handle —
        the index will alias the next reservation.  This is what
        :func:`repro_torch.analyze.liveness.allocator_findings` audits.
        """
        return tuple(self._free)

    def alloc_row(self, tag: str = "") -> Row:
        return self.alloc(1, tag=tag)[0]

    def alloc(self, n: int, tag: str = "") -> PlaneGroup:
        if n < 1:
            raise RowAllocationError(
                f"{self.name}: cannot allocate {n} rows (tag {tag!r})")
        if self.capacity is not None and self.in_use + n > self.capacity:
            raise RowAllocationError(
                f"{self.name}: out of rows allocating {n} more "
                f"(tag {tag!r}): {self.in_use}/{self.capacity} in use")
        indices = [self._free.pop() for _ in range(min(n, len(self._free)))]
        fresh = n - len(indices)
        indices.extend(range(self._next, self._next + fresh))
        self._next += fresh
        rows = tuple(Row(i, tag=tag, allocator=self) for i in indices)
        return PlaneGroup(rows)

    def free(self, rows) -> None:
        """Release a :class:`Row`/:class:`PlaneGroup` back to the pool.

        Ownership is validated; double-frees raise.  See the class
        docstring for the handle-invalidation contract.
        """
        rows = (rows,) if isinstance(rows, Row) else tuple(rows)
        # A set of the free list: the reference tests each row against
        # the list itself, which is quadratic in a model-sized release.
        on_free = set(self._free)
        for row in rows:
            if not self.owns(row):
                raise RowAllocationError(
                    f"{self.name}: cannot free row "
                    f"{getattr(row, 'index', row)!r}: not allocated here")
            if row.index in on_free or row.index >= self._next:
                raise RowAllocationError(
                    f"{self.name}: double free of row {row.index} "
                    f"(tag {row.tag!r})")
        self._free.extend(row.index for row in rows)

    def owns(self, row: Row) -> bool:
        return isinstance(row, Row) and row.allocator is self
