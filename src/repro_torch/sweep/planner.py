"""Grid planner: carve a sweep grid into backend-native batches.

The runner's unit of work (and of resume) is a :class:`Chunk` — a
contiguous slice of grid points that one backend can execute as a
single batch.  Points are grouped by *batch signature* before chunking:

* ``majx``: (backend, x, rows, words) — every point in the chunk stacks
  to one ``(B, X, R, C)`` tensor, which the ``cuda`` backend runs as one
  fused Program level (one MAJX kernel launch) and the ``sim`` /
  ``oracle`` backends execute point-by-point;
* ``mrc``: (backend, n_dest) — bulk ``rowcopy`` calls share a fan-out;
* ``simra`` / ``analytic``: (backend,) — vectorized surface evaluation.

Chunk keys are derived from the dense point indices, which are stable
for a given spec (see :meth:`repro_torch.sweep.spec.SweepSpec.points`), so a
restarted campaign maps its chunks onto the completed set exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.pud.isa import Program
from repro_torch.sweep.spec import ANALYTIC, GridPoint, SweepSpec


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A batch of grid points executed and persisted as one unit."""

    key: str
    backend: str
    points: tuple[GridPoint, ...]

    @property
    def indices(self) -> tuple[int, ...]:
        return tuple(p.index for p in self.points)


def _signature(spec: SweepSpec, p: GridPoint) -> tuple:
    if p.backend == ANALYTIC or spec.op == "simra":
        return (p.backend,)
    if spec.op == "majx":
        return (p.backend, p.x, spec.rows, spec.words)
    return (p.backend, p.n_dest)


def _chunk_key(points: Iterable[GridPoint]) -> str:
    idx = [p.index for p in points]
    return f"chunk-{min(idx):06d}-{max(idx):06d}"


def plan(spec: SweepSpec) -> list[Chunk]:
    """All chunks of a sweep, in deterministic execution order."""
    groups: dict[tuple, list[GridPoint]] = {}
    order: list[tuple] = []
    for p in spec.points():
        sig = _signature(spec, p)
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(p)

    chunks: list[Chunk] = []
    for sig in order:
        pts = groups[sig]
        for i in range(0, len(pts), spec.chunk):
            batch = tuple(pts[i:i + spec.chunk])
            chunks.append(Chunk(_chunk_key(batch), batch[0].backend, batch))
    return chunks


def fused_majx_program(points: Sequence[GridPoint], rows: int
                       ) -> tuple[Program, int]:
    """Lower one majx chunk to an addressed Program for ``run_fused``.

    Row layout of the expected state image (width = ``spec.words``):
    operand plane ``i`` of point ``b``'s row-image ``r`` lives at row
    ``(b * x + i) * rows + r``; the chunk's stacked ``(B, X, R, C)``
    data tensor reshapes to exactly this (then ``B * R`` zeroed output
    rows are appended).  Every MAJ op is independent, so the whole chunk
    is one dependency level — one batched kernel dispatch on the
    ``cuda`` backend, the same fusion the §8.1 programs get, instead
    of a planner-private batching path.

    Returns ``(program, out_base)`` with outputs for point ``b`` at rows
    ``out_base + b * rows + r``.
    """
    x = points[0].x
    prog = Program()
    out_base = len(points) * x * rows
    for b, p in enumerate(points):
        for r in range(rows):
            prog.emit(
                "MAJ", x=x, n_act=p.n_act, tag=f"sweep/pt{p.index}[{r}]",
                srcs=tuple((b * x + i) * rows + r for i in range(x)),
                dsts=(out_base + b * rows + r,))
    return prog, out_base


def chunks_by_point(chunks: Iterable[Chunk]) -> dict[int, Chunk]:
    """Map every grid-point index to the chunk that executes it.

    The adaptive boundary search (:mod:`repro_torch.sweep.adaptive`) probes
    individual grid points but executes/persists whole planned chunks,
    so its stores stay interchangeable with grid-mode stores.
    """
    return {p.index: c for c in chunks for p in c.points}


def shard(chunks: list[Chunk], num_shards: int, shard_index: int
          ) -> list[Chunk]:
    """Round-robin partition of chunks across ``num_shards`` workers.

    Deterministic in chunk order, so independent workers given the same
    spec agree on the partition without coordination; each worker writes
    disjoint chunk files into the shared record store.
    """
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} outside "
                         f"[0, {num_shards})")
    return [c for i, c in enumerate(chunks) if i % num_shards == shard_index]
