"""Execution plan of a megakernel lowering: the live slots, and nothing else.

A :class:`~repro_torch.compile.megakernel.MegaLowering` pads every level
to the widest level and every vote to the widest arity, so that the
reference's TPU kernel can walk fixed-shape tables.  On §8.1 programs
that padding dominates: mul at tier 5 has 2,112 live slots among 78,186,
div at MAJ3 14,784 among 3,608,000.  :func:`build_plan` derives, once
per lowering, the slots whose writes can be observed, with the tables
left as they are (their digests stay the reference's):

* **inert slots go.**  A slot that writes ``TRASH_ROW`` is dropped when
  no slot of the lowering reads ``TRASH_ROW`` (the trash row is not part
  of the result); otherwise it is kept like any other slot;
* **superseded writes go.**  Every slot of a level reads the level-entry
  image, and two slots of one level writing the same row leave the last
  one's vote, so only the last writer of each row is kept;
* **constant pairs go.**  Matched (``ZERO_ROW``, ``ONE_ROW``) operand
  pairs are dropped (``MAJ_k == MAJ_{k+2m}(.., 0*m, 1*m)``, exact for
  any k), unless some slot writes a constant row, which would make the
  pair something else.  A slot keeps its real arity k, its threshold
  ``k // 2 + 1`` (strict majority, ``(k + 1) / 2`` for odd k; on an
  even k a tie is 0, as in the padded-table oracle ``ref.py``), its
  complement flag and its destination;
* **empty levels go;**
* **hazard slots are marked.**  A kept slot whose destination row is
  read by another kept slot of its level is a hazard slot: its vote must
  wait until every read of the level is done.  Every other slot may
  write straight into the image.  Within a level the plan lists the
  plain slots first, then the hazard slots.

The arrays are CSR: ``level_ptr`` indexes slots, ``op_ptr`` indexes
operands.  :func:`plan_for` memoizes the plan on the lowering object,
and :attr:`ExecPlan.key` is derived from the lowering's digest.
:func:`exec_plan_ref` is the plain PyTorch walker of a plan (the CPU
route of :func:`~repro_torch.kernels.megakernel.ops.run_lowering`), and
:func:`plan_launch` picks the CUDA kernel's regime and strip width.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW, TRASH_ROW, ZERO_ROW)
from repro_torch.core import bitplanes as bp

#: Version of the planning rules, folded into :attr:`ExecPlan.key`.
PLAN_VERSION = 1
#: Most levels, slot records and operands a block stages in shared
#: memory at once (:meth:`ExecPlan.chunk_records`).
STAGE_LEVELS, STAGE_SLOTS, STAGE_OPS = 256, 512, 2048


@dataclasses.dataclass(frozen=True, eq=False)
class ExecPlan:
    """The kept slots of a lowering, level by level (CSR arrays).

    Level ``l`` owns slots ``level_ptr[l]:level_ptr[l + 1]``, of which
    the last ``n_hazard[l]`` are hazard slots; slot ``s`` reads the
    augmented rows ``operands[op_ptr[s]:op_ptr[s + 1]]`` and writes row
    ``dst[s]``, complemented where ``inv[s]`` is 1.
    """

    level_ptr: np.ndarray   # (n_levels + 1,) int32
    n_hazard: np.ndarray    # (n_levels,) int32
    op_ptr: np.ndarray      # (n_slots + 1,) int32
    operands: np.ndarray    # (n_operands,) int32
    dst: np.ndarray         # (n_slots,) int32
    inv: np.ndarray         # (n_slots,) int32, 0 or 1
    key: str
    #: (min, max) row of the lowering's ``src`` and ``dst`` tables, padding
    #: included, so a run validates them without reading the tables.
    table_rows: dict

    @property
    def n_levels(self) -> int:
        return len(self.level_ptr) - 1

    @property
    def n_slots(self) -> int:
        return len(self.dst)

    @property
    def arity(self) -> np.ndarray:
        """(n_slots,) real arity of each kept slot."""
        return np.diff(self.op_ptr)

    @property
    def thresh(self) -> np.ndarray:
        """(n_slots,) votes a bit needs to be 1: ``arity // 2 + 1``."""
        return self.arity // 2 + 1

    @property
    def max_arity(self) -> int:
        return int(self.arity.max()) if self.n_slots else 0

    @property
    def max_hazard(self) -> int:
        """Most hazard slots in one level (votes a kernel must hold)."""
        return int(self.n_hazard.max()) if self.n_levels else 0

    def hazard_mask(self) -> np.ndarray:
        """(n_slots,) bool: True for hazard slots."""
        mask = np.zeros(self.n_slots, bool)
        for lo, hi, h in zip(self.level_ptr[:-1], self.level_ptr[1:],
                             self.n_hazard):
            mask[hi - h:hi] = True
        return mask

    def slot_records(self) -> np.ndarray:
        """(n_slots, 4) int32 ``[op_begin, arity, dst, inv]``: one 16-byte
        record a slot, as ``csrc/megakernel.cu`` reads it."""
        return np.stack([self.op_ptr[:-1], self.arity, self.dst, self.inv],
                        axis=1).astype(np.int32).reshape(-1, 4)

    def level_records(self) -> np.ndarray:
        """(n_levels, 4) int32 ``[slot_begin, n_plain, n_hazard, 0]``."""
        begin = self.level_ptr[:-1]
        n = np.diff(self.level_ptr)
        return np.stack([begin, n - self.n_hazard, self.n_hazard,
                         np.zeros_like(begin)], axis=1).astype(
                             np.int32).reshape(-1, 4)


    @functools.cached_property
    def chunks(self) -> np.ndarray:
        """(n_chunks, 8) int32 ``[level_begin, level_end, slot_begin,
        slot_end, op_begin, op_end, staged, 0]``.

        Consecutive levels grouped so that each group's plan entries fit
        the stage (:data:`STAGE_LEVELS`, :data:`STAGE_SLOTS`,
        :data:`STAGE_OPS`): the kernel copies a group into shared memory
        with all its threads at once, then reads its tables from there.
        A single level too large for the stage is a group of its own
        with ``staged`` 0, read from device memory.
        """
        lp, op = self.level_ptr.tolist(), self.op_ptr.tolist()
        out, l, n = [], 0, self.n_levels
        while l < n:
            l0, s0 = l, lp[l]
            while (l < n and l + 1 - l0 <= STAGE_LEVELS
                   and lp[l + 1] - s0 <= STAGE_SLOTS
                   and op[lp[l + 1]] - op[s0] <= STAGE_OPS):
                l += 1
            staged = int(l > l0)
            l = max(l, l0 + 1)
            out.append([l0, l, s0, lp[l], op[s0], op[lp[l]], staged, 0])
        return np.asarray(out, np.int32).reshape(-1, 8)

    @functools.cached_property
    def stage(self) -> tuple[int, int, int]:
        """(levels, slots, operands) the largest staged chunk holds."""
        c = self.chunks[self.chunks[:, 6] == 1]
        if not len(c):
            return (0, 0, 0)
        return tuple(int((c[:, hi] - c[:, lo]).max())
                     for lo, hi in ((0, 1), (2, 3), (4, 5)))

    @property
    def stage_bytes(self) -> int:
        """Shared memory of the stage: 16-byte level and slot records,
        4-byte operands."""
        levels, slots, ops = self.stage
        return 16 * (levels + slots) + 4 * ops


def plan_key(lowering: MegaLowering) -> str:
    """Content key of the plan of ``lowering``, from its digest."""
    return hashlib.sha256(f"exec-plan/{PLAN_VERSION}|{lowering.digest()}"
                          .encode()).hexdigest()


def build_plan(lowering: MegaLowering) -> ExecPlan:
    """Derive the execution plan of ``lowering`` (see module docstring).

    Exact for any tables: the walk of the plan equals
    :func:`~repro_torch.kernels.megakernel.ref.schedule_exec_ref` on
    every image the tables can run against.
    """
    src = np.asarray(lowering.src)
    dst = np.asarray(lowering.dst)
    inv = np.asarray(lowering.inv)
    trash_read = bool((src == TRASH_ROW).any())
    const_written = bool(np.isin(dst, (ZERO_ROW, ONE_ROW)).any())
    live = np.ones(dst.shape, bool) if trash_read else dst != TRASH_ROW

    level_ptr, n_hazard, op_ptr = [0], [], [0]
    operands, dsts, invs = [], [], []
    for li in range(lowering.n_levels):
        cand = np.flatnonzero(live[li])
        if not cand.size:
            continue
        last = {}                       # dst row -> its last slot
        for w, d in zip(cand.tolist(), dst[li, cand].tolist()):
            last[d] = w
        kept = sorted(last.values())
        reads = {}
        for w, ops in zip(kept, src[li, kept].tolist()):
            if not const_written:
                pairs = min(ops.count(ZERO_ROW), ops.count(ONE_ROW))
                for row in (ZERO_ROW, ONE_ROW):
                    for _ in range(pairs):
                        ops.remove(row)
            reads[w] = ops
        # Rows read by a slot, and by how many slots: a slot is a hazard
        # when its destination is read by any slot other than itself.
        readers: dict[int, set] = {}
        for w in kept:
            for r in reads[w]:
                readers.setdefault(r, set()).add(w)
        hazard = {w for w in kept
                  if readers.get(int(dst[li, w]), set()) - {w}}
        order = ([w for w in kept if w not in hazard]
                 + [w for w in kept if w in hazard])
        for w in order:
            operands.extend(reads[w])
            op_ptr.append(len(operands))
            dsts.append(int(dst[li, w]))
            invs.append(1 if inv[li, w] else 0)
        level_ptr.append(len(dsts))
        n_hazard.append(len(hazard))

    def i32(a):
        return np.asarray(a, np.int32)

    return ExecPlan(level_ptr=i32(level_ptr), n_hazard=i32(n_hazard),
                    op_ptr=i32(op_ptr), operands=i32(operands),
                    dst=i32(dsts), inv=i32(invs), key=plan_key(lowering),
                    table_rows={name: (int(t.min()), int(t.max()))
                                for name, t in (("src", src), ("dst", dst))})


_PLANS: "weakref.WeakKeyDictionary[MegaLowering, ExecPlan]" = \
    weakref.WeakKeyDictionary()


def plan_for(lowering: MegaLowering) -> ExecPlan:
    """The plan of ``lowering``, built once per lowering object (a
    lowering's tables are not modified after it is made)."""
    plan = _PLANS.get(lowering)
    if plan is None:
        plan = build_plan(lowering)
        _PLANS[lowering] = plan
    return plan


def exec_plan_ref(plan: ExecPlan, state: torch.Tensor) -> torch.Tensor:
    """Walk ``plan`` on a (rows, words) int32 image, in plain PyTorch.

    Per level, the plain slots' votes are computed and written first,
    then the hazard slots' votes are computed from that image and
    written: exact only because no plain slot's destination is read in
    its level, the guarantee the CUDA kernel relies on too.  Votes are
    batched by arity (word-parallel majority).  Returns the program
    rows of the final image; the caller's tensor is not written.
    """
    rows, words = state.shape
    aug = state.new_zeros((rows + N_CONST_ROWS, words))
    aug[ONE_ROW] = bp.ONES
    aug[N_CONST_ROWS:] = state
    arity = plan.arity
    for lo, hi, h in zip(plan.level_ptr[:-1].tolist(),
                         plan.level_ptr[1:].tolist(), plan.n_hazard.tolist()):
        for first, last in ((lo, hi - h), (hi - h, hi)):
            writes = []
            for k in np.unique(arity[first:last]).tolist():
                slots = first + np.flatnonzero(arity[first:last] == k)
                if k == 0:
                    votes = aug.new_zeros((len(slots), words))
                else:
                    idx = plan.operands[plan.op_ptr[slots][:, None]
                                        + np.arange(k)]
                    votes = bp.majority_words(
                        aug[torch.as_tensor(idx, device=aug.device)], axis=1)
                flip = torch.as_tensor(plan.inv[slots].astype(bool),
                                       device=aug.device)
                votes = torch.where(flip[:, None], ~votes, votes)
                writes.append((plan.dst[slots], votes))
            for d, votes in writes:
                aug[torch.as_tensor(d, dtype=torch.int64,
                                    device=aug.device)] = votes
    return aug[N_CONST_ROWS:]


# ------------------------------------------------------------- launch plan
#: Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
#: Shared memory of one SM (228 KB), for blocks-per-SM arithmetic.
SMEM_PER_SM = 233_472
#: Per-block shared memory the runtime reserves.
SMEM_RESERVED = 1024
#: Strip widths (word columns a block) the planner considers, widest
#: first; 8 words are one 32-byte sector of a row.
RESIDENT_STRIPS = (128, 64, 32, 16, 8)
STREAMING_STRIPS = (32, 16, 8, 4, 2, 1)
#: Resident only where one SM's shared memory holds at least this many
#: word columns of the image.  A level costs a block a fixed latency
#: whatever its width, so the columns in flight on an SM set the rate;
#: with few resident columns streaming through L2 wins.  On the H100
#: resident won with 354 columns an SM (add32) and lost with 26 (mul at
#: tier 5); 96 is chosen between the two, the crossover itself is not
#: measured (PERF.md).
RESIDENT_MIN_COLUMNS = 96
SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/megakernel.cu`` runs one plan on one image.

    ``regime`` is ``"resident"`` (the block's strip of the whole
    augmented image lives in shared memory) or ``"streaming"`` (the
    image stays in device memory; shared memory holds only the hazard
    votes).  ``strip`` word columns a block, ``threads`` a block,
    ``smem_bytes`` of dynamic shared memory, ``blocks`` in the grid.
    """

    regime: str
    strip: int
    threads: int
    smem_bytes: int
    blocks: int


def _smem(plan: ExecPlan, regime: str, rows_aug: int, strip: int) -> int:
    """Dynamic shared memory of a block: the image strip (resident) and
    the hazard votes, 16-byte aligned, then the plan's stage."""
    held = plan.max_hazard + (rows_aug if regime == "resident" else 0)
    return -(-held * strip * 4 // 16) * 16 + plan.stage_bytes


def plan_launch(plan: ExecPlan, rows: int, words: int, *,
                regime: Optional[str] = None) -> LaunchPlan:
    """Pick the regime, strip width and block size from the shapes alone.

    The Hopper counterpart of :func:`~repro_torch.compile.megakernel.
    plan_vmem`.  Resident where one SM's shared memory holds
    :data:`RESIDENT_MIN_COLUMNS` columns of the ``rows + 3``-row
    augmented image and a strip of 8 fits :data:`SMEM_LIMIT`, with the
    widest strip at which two blocks share an SM (else the widest that
    fits) and 256 threads.  Otherwise streaming, with the widest strip
    that still gives half the SMs a block (narrower where the hazard
    votes need it) and 128 threads.  ``regime`` forces a regime (the
    tests cover both this way); a forced regime that does not fit
    raises.
    """
    rows_aug = rows + N_CONST_ROWS
    if regime not in (None, "resident", "streaming"):
        raise ValueError(f"unknown megakernel regime {regime!r}")

    def fitting(reg, strips, limit=SMEM_LIMIT):
        return [s for s in strips if _smem(plan, reg, rows_aug, s) <= limit]

    if regime is None:
        columns = (SMEM_PER_SM - SMEM_RESERVED) // (4 * rows_aug)
        regime = ("resident" if columns >= RESIDENT_MIN_COLUMNS
                  and fitting("resident", (8,)) else "streaming")
    if regime == "resident":
        half = SMEM_PER_SM // 2 - SMEM_RESERVED
        strip = next(iter(fitting("resident", RESIDENT_STRIPS, half)
                          + fitting("resident", RESIDENT_STRIPS)), None)
    else:
        fit = fitting("streaming", STREAMING_STRIPS)
        strip = next((s for s in fit if -(-words // s) >= SMS // 2),
                     fit[-1] if fit else None)
    if strip is None:
        narrowest = (RESIDENT_STRIPS if regime == "resident"
                     else STREAMING_STRIPS)[-1]
        raise ValueError(
            f"megakernel {regime}: "
            f"{_smem(plan, regime, rows_aug, narrowest)} bytes of shared "
            f"memory for a {narrowest}-column strip of a {rows_aug}-row "
            f"image with {plan.max_hazard} hazard votes exceed "
            f"{SMEM_LIMIT}")
    smem = _smem(plan, regime, rows_aug, strip)
    threads = 256 if regime == "resident" else 128
    blocks = max(1, min(-(-words // strip), 2**31 - 1))
    return LaunchPlan(regime=regime, strip=int(strip), threads=int(threads),
                      smem_bytes=int(smem), blocks=int(blocks))
