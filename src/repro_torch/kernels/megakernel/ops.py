"""Host-side wrapper: run a MegaLowering against a bit-plane image.

:func:`run_lowering` validates the tables against the image, takes the
lowering's execution plan (:mod:`repro_torch.kernels.megakernel.plan`:
the live slots, hazard slots marked), and launches ``csrc/megakernel.cu``
exactly once on it, in the regime :func:`~repro_torch.kernels.megakernel.
plan.plan_launch` picks from the shapes.  On a CPU image it walks the
same plan with :func:`~repro_torch.kernels.megakernel.plan.exec_plan_ref`.
``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW)
from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.megakernel.plan import (ExecPlan, exec_plan_ref,
                                                 plan_for, plan_launch)

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = ([launch.VOID_P] * 6 + [launch.I32] * 2 + [launch.I64]
         + [launch.I32] * 10 + [launch.VOID_P])


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A lowering's execution plan, and its arrays on one device."""

    plan: ExecPlan
    chunks: torch.Tensor     # (n_chunks, 8) int32
    levels: torch.Tensor     # (n_levels, 4) int32
    slots: torch.Tensor      # (n_slots, 4) int32
    operands: torch.Tensor   # (n_operands,) int32


def upload_tables(lowering: MegaLowering, device) -> DeviceTables:
    """Plan ``lowering`` and copy the plan to ``device`` (once per
    lowering: the ``cuda`` backend caches the result by
    :meth:`MegaLowering.digest`)."""
    plan = plan_for(lowering)

    def put(a):
        return torch.as_tensor(a, dtype=torch.int32,
                               device=device).contiguous()
    return DeviceTables(plan, put(plan.chunks), put(plan.level_records()),
                        put(plan.slot_records()), put(plan.operands))


def run_lowering(lowering: MegaLowering, state: torch.Tensor, *,
                 tables: Optional[DeviceTables] = None,
                 regime: Optional[str] = None) -> torch.Tensor:
    """Execute lowered level tables on a (rows, words) int32 image.

    One kernel launch regardless of level count.  Rows beyond what the
    lowering addresses ride along untouched; an empty lowering is the
    identity (a copy, no launch).  The caller's tensor is never written.
    ``regime`` overrides the launch planner's choice (:func:`~repro_torch.
    kernels.megakernel.plan.plan_launch`); a forced regime that does not
    fit raises, it is never swapped.
    """
    global launches
    launch.check_words("megakernel", state, min_ndim=2)
    if state.dim() != 2:
        raise ValueError(f"megakernel: state must be (rows, words), got "
                         f"{tuple(state.shape)}")
    rows, words = state.shape
    if lowering.n_levels == 0 or lowering.w_max == 0:
        return state.clone()
    if lowering.n_rows > rows:
        raise ValueError(
            f"lowering addresses {lowering.n_rows} rows but state has "
            f"only {rows}")
    # The plan, built once per lowering, carries the tables' row range:
    # a run does not read the padded tables again.
    plan = plan_for(lowering)
    for name, (lo, hi) in plan.table_rows.items():
        if lo < 0 or hi >= rows + N_CONST_ROWS:
            raise ValueError(f"lowering {name} table indexes outside the "
                             f"{rows + N_CONST_ROWS}-row augmented image")
    if launch.on_cpu(state):
        return exec_plan_ref(plan, state)

    if tables is None:
        tables = upload_tables(lowering, state.device)
    plan = tables.plan
    lp = plan_launch(plan, rows, words, regime=regime)
    if lp.regime == "resident":
        out = torch.empty_like(state)
        src, result = state, out
    else:
        image = torch.empty((rows + N_CONST_ROWS, words), dtype=torch.int32,
                            device=state.device)
        image[:N_CONST_ROWS] = 0
        image[ONE_ROW] = bp.ONES
        image[N_CONST_ROWS:] = state
        src, result, out = None, image, image[N_CONST_ROWS:]
    # Four columns an item (16-byte accesses) where the layout allows.
    vec = (words % 4 == 0 and lp.strip % 4 == 0
           and all(t.data_ptr() % 16 == 0
                   for t in (src, result) if t is not None))
    # The stage follows the image strip and the held votes, 16-byte
    # aligned (plan.py, _smem).
    stage_levels, stage_slots, _ = plan.stage
    stage = (lp.smem_bytes - plan.stage_bytes) // 4
    fn = launch.kernel("megakernel", "megakernel_launch", _ARGS)
    launch.run(fn, "megakernel", state.device,
               src.data_ptr() if src is not None else None,
               result.data_ptr(), tables.chunks.data_ptr(),
               tables.levels.data_ptr(), tables.slots.data_ptr(),
               tables.operands.data_ptr(), len(plan.chunks),
               rows + N_CONST_ROWS, words, plan.max_arity,
               int(lp.regime == "resident"), lp.strip, int(vec),
               lp.smem_bytes, stage, stage_levels, stage_slots, lp.blocks,
               lp.threads)
    launches += 1
    return out
