"""Megakernel lowering: a whole fused Schedule as ONE kernel's level tables.

The level-fused executor (:meth:`repro_torch.backends.cuda.CudaBackend.
run_fused`) collapses each dependency level into at most one MAJX plus
one Multi-RowCopy dispatch — but a 34-level adder is still 34 kernel
launches.  This module lowers a :class:`~repro_torch.compile.schedule.
Schedule` to *static level tables* that a single kernel launch executes
end-to-end (``csrc/megakernel.cu``).

Lowering model — every schedulable op becomes one or more **write
slots**, and a level is a fixed-width array of slots:

* a ``MAJ_k`` op is one slot per destination row, its ``k`` operand
  indices padded to the program-wide widest arity ``x_max`` with
  constant (all-0, all-1) row *pairs* — the exact
  ``MAJ_k == MAJ_{k+2m}(.., 0*m, 1*m)`` identity the level-fused path
  already relies on;
* a Multi-RowCopy wave is one arity-1 identity slot per destination
  (``MAJ_1(src) == src``), so an MRC's fan-out becomes ``len(dsts)``
  parallel slots of one level;
* ``NOT`` / ``COPY`` are arity-1 identity slots, NOT with the slot's
  invert flag set (the kernel complements the vote);
* levels narrower than the widest level pad with inert slots that read
  the constant zero row and write the trash row.

The executing kernel therefore needs exactly one primitive — gather
``(W, X)`` operand rows, bit-sliced majority over ``X`` packed words,
optional complement, scatter to ``W`` destination rows — repeated
``n_levels`` times inside one launch.  WAW leveling guarantees each
level's scatters hit disjoint rows, and all reads sample the level-entry
state, so megakernel execution is bit-identical to per-op interpretation
by construction.

Row-space layout: the kernel image prepends three **constant rows** in
front of the program's rows, so a lowering depends only on program
content (never on the height of the state it later runs against):

    row 0: all-zero   (MAJ padding, inert-slot source)
    row 1: all-one    (MAJ padding)
    row 2: trash      (inert-slot destination)
    row 3..: program rows, shifted by :data:`N_CONST_ROWS`

This module is a copy of the reference package's lowering, so the
tables and their :meth:`MegaLowering.digest` are byte-identical to it.
:func:`plan_vmem` is kept for that parity (it plans the reference's TPU
column blocks); the CUDA megakernel does not use it, because one thread
owns one word column and needs no column blocking.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.compile.schedule import Schedule

#: Augmented-image layout (see module docstring).
ZERO_ROW = 0
ONE_ROW = 1
TRASH_ROW = 2
N_CONST_ROWS = 3


@dataclasses.dataclass(frozen=True, eq=False)
class MegaLowering:
    """Static level tables for one-dispatch execution of a Schedule.

    ``src``: (n_levels, w_max, x_max) int32 operand row indices into the
    augmented image; ``dst``: (n_levels, w_max) int32 destination rows;
    ``inv``: (n_levels, w_max) uint32 complement flags (1 = XOR the vote
    with all-ones).  ``level_meta`` records, per level, the live slot
    counts by kind ``(MAJ, MRC, NOT, COPY)`` — the structural shape the
    golden fixtures freeze so a lowering change that silently reorders
    levels fails loudly.
    """

    src: np.ndarray
    dst: np.ndarray
    inv: np.ndarray
    n_rows: int
    level_meta: tuple[tuple[int, int, int, int], ...]

    @property
    def n_levels(self) -> int:
        return self.src.shape[0]

    @property
    def w_max(self) -> int:
        """Write slots per level (the padded level width)."""
        return self.src.shape[1]

    @property
    def x_max(self) -> int:
        """Operand slots per write slot (the padded vote arity; odd)."""
        return self.src.shape[2]

    @property
    def table_bytes(self) -> int:
        """Bytes of the three level tables."""
        return self.src.nbytes + self.dst.nbytes + self.inv.nbytes

    def digest(self) -> str:
        """Content fingerprint of the lowered tables.

        Golden fixtures freeze this: any change to level order, slot
        packing, padding policy, or constant-row layout changes the
        digest even when the final state happens to agree.
        """
        h = hashlib.sha256()
        h.update(f"{self.src.shape}|{self.n_rows}\n".encode())
        for arr in (self.src, self.dst, self.inv):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()


def lower_schedule(sched: Schedule) -> MegaLowering:
    """Lower a fused Schedule to :class:`MegaLowering` level tables.

    Pure function of schedule content: two programs with identical op
    streams lower to byte-identical tables (what makes the artifact
    cacheable under the schedule's own content hash).
    """
    x_max = 1
    w_max = 0
    n_rows = 0
    for lvl in sched.levels:
        width = 0
        for g in lvl:
            if g.kind == "MAJ":
                x_max = max(x_max, g.param)
            for op in g.ops:
                width += len(op.dsts)
                for r in op.srcs + op.dsts:
                    n_rows = max(n_rows, r + 1)
        w_max = max(w_max, width)

    n_levels = len(sched.levels)
    src = np.full((n_levels, w_max, x_max), ZERO_ROW, np.int32)
    dst = np.full((n_levels, w_max), TRASH_ROW, np.int32)
    inv = np.zeros((n_levels, w_max), np.uint32)
    meta = []
    for li, lvl in enumerate(sched.levels):
        slot = 0
        counts = {"MAJ": 0, "MRC": 0, "NOT": 0, "COPY": 0}
        for g in lvl:
            for op in g.ops:
                if g.kind == "MAJ":
                    k = len(op.srcs)
                    if (x_max - k) % 2:
                        raise ValueError(
                            f"cannot pad MAJ{k} to MAJ{x_max}: parity "
                            f"differs")
                    pad = (x_max - k) // 2
                    operands = ([s + N_CONST_ROWS for s in op.srcs]
                                + [ZERO_ROW] * pad + [ONE_ROW] * pad)
                else:  # MRC / NOT / COPY: arity-1 identity vote
                    pad = (x_max - 1) // 2
                    operands = ([op.srcs[0] + N_CONST_ROWS]
                                + [ZERO_ROW] * pad + [ONE_ROW] * pad)
                for d in op.dsts:
                    src[li, slot] = operands
                    dst[li, slot] = d + N_CONST_ROWS
                    inv[li, slot] = 1 if g.kind == "NOT" else 0
                    counts[g.kind] += 1
                    slot += 1
        meta.append((counts["MAJ"], counts["MRC"], counts["NOT"],
                     counts["COPY"]))
    return MegaLowering(src=src, dst=dst, inv=inv, n_rows=n_rows,
                        level_meta=tuple(meta))


@dataclasses.dataclass(frozen=True)
class VmemPlan:
    """Column-blocking decision for one megakernel launch.

    ``resident`` means the whole augmented image fits one VMEM block
    (single grid step); otherwise the word axis splits into ``block_c``
    -wide column slabs streamed through the Pallas pipeline's
    double-buffered HBM fetches.  Either way: one dispatch.
    """

    block_c: int
    resident: bool
    working_set_bytes: int
    budget_bytes: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def plan_vmem(lowering: MegaLowering, rows: int, words: int,
              budget_bytes: int, *, block_r: int = 8,
              lane_width: int = 128) -> VmemPlan:
    """Pick the widest VPU-aligned column block the VMEM budget allows.

    Bytes per word column: the state block appears twice (pipeline in +
    out buffers) plus the per-level gather ``(w_max, x_max)`` operand
    planes and the vote's counter digits; the scalar-prefetch tables are
    charged once, column-independent.
    """
    rows_aug = -(-(rows + N_CONST_ROWS) // block_r) * block_r
    words_padded = -(-words // lane_width) * lane_width
    digits = max(lowering.x_max.bit_length(), 1)
    per_col = 4 * (2 * rows_aug
                   + lowering.w_max * (lowering.x_max + digits + 1))
    usable = max(budget_bytes - lowering.table_bytes, per_col * lane_width)
    block_c = max(usable // per_col // lane_width, 1) * lane_width
    block_c = min(block_c, words_padded)
    working = per_col * words_padded + lowering.table_bytes
    return VmemPlan(block_c=int(block_c),
                    resident=bool(block_c >= words_padded),
                    working_set_bytes=int(working),
                    budget_bytes=int(budget_bytes))
