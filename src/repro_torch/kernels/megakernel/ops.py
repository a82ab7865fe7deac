"""Host-side wrapper: run a MegaLowering against a bit-plane image.

:func:`run_lowering` validates the tables against the image, takes the
lowering's execution plan and its arrays on the image's device from the
lowering's memo (:mod:`repro_torch.kernels.megakernel.plan`: the live
slots, hazard slots marked), and launches ``csrc/megakernel.cu``
exactly once on it, in the regime :func:`~repro_torch.kernels.megakernel.
plan.plan_launch` picks from the shapes.  On a CPU image it walks the
same plan with :func:`~repro_torch.kernels.megakernel.plan.exec_plan_ref`.
``launches`` counts kernel launches, and nothing else.  A streaming
launch counts the rows it copies from the caller's image into the
output in ``megakernel.passthrough_rows`` (:mod:`repro_torch.obs`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.compile.megakernel import MegaLowering, N_CONST_ROWS
from repro_torch.kernels import launch
from repro_torch.kernels.megakernel.plan import (exec_plan_ref, plan_for,
                                                 plan_launch, tables_for)

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = ([launch.VOID_P] * 7 + [launch.I32] * 4 + [launch.I64]
         + [launch.I32] * 10 + [launch.VOID_P])


def run_lowering(lowering: MegaLowering, state: torch.Tensor, *,
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

    tables = tables_for(lowering, state.device)
    lp = plan_launch(plan, rows, words, regime=regime)
    if lp.regime == "resident":
        out = result = torch.empty_like(state)
        ops = tables.operands
    else:
        # The kernel reads `state` in place and writes only `result`: it
        # makes the constant rows and copies the rows no kept slot writes
        # (the plan's pass-through rows, then the rows past the
        # lowering's), so nothing needs filling or copying here.
        result = torch.empty((rows + N_CONST_ROWS, words),
                             dtype=torch.int32, device=state.device)
        out = result[N_CONST_ROWS:]
        ops = tables.stream_operands
        obs.count("megakernel.passthrough_rows",
                  len(plan.passthrough) + rows - plan.n_rows)
    # Four columns an item (16-byte accesses) where the layout allows.
    vec = (words % 4 == 0 and lp.strip % 4 == 0
           and state.data_ptr() % 16 == 0 and result.data_ptr() % 16 == 0)
    # The stage follows the image strip and the held votes, 16-byte
    # aligned (plan.py, _smem).
    stage_levels, stage_slots, _ = plan.stage
    stage = (lp.smem_bytes - plan.stage_bytes) // 4
    fn = launch.kernel("megakernel", "megakernel_launch", _ARGS)
    launch.run(fn, "megakernel", state.device, state.data_ptr(),
               result.data_ptr(), tables.chunks.data_ptr(),
               tables.levels.data_ptr(), tables.slots.data_ptr(),
               ops.data_ptr(), tables.passthrough.data_ptr(),
               len(plan.chunks), len(plan.passthrough), plan.n_rows,
               rows + N_CONST_ROWS, words, plan.max_arity,
               int(lp.regime == "resident"), lp.strip, int(vec),
               lp.smem_bytes, stage, stage_levels, stage_slots, lp.blocks,
               lp.threads)
    launches += 1
    return out
