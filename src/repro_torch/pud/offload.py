"""PUD-vs-GPU offload planner.

The paper demonstrates that COTS DRAM computes bulk bitwise ops
in-place.  Whether offloading such an op from the GPU to a PUD-capable
memory pays off depends on (a) the GPU roofline cost of the op (pure
bandwidth for bitwise work, plus one launch per kernel dispatch) vs
(b) the PUD command-schedule latency including success-rate-driven
retries, and (c) the saved device-memory traffic.  This planner prices
both sides — nanoseconds AND nanojoules — and is advisory: on a
GPU-only deployment the ``cuda`` backend runs the op either way.

The PUD side (latency, energy, retries) is the reference package's,
priced identically.  The accelerator side is the port's H100 profile
(:data:`repro_torch.core.costmodel.COST`: 3.35 TB/s HBM3, the measured
per-launch host overhead, 700 W board power), and its names say so.
Each replaces a reference name:

====================================  ==================================
port                                  reference (``repro.pud.offload``)
====================================  ==================================
``gpu_bitwise_ns``                    ``tpu_bitwise_ns``
``gpu_bitwise_energy_nj``             ``tpu_bitwise_energy_nj``
``gpu_program_ns``                    ``tpu_program_ns``
``gpu_program_energy_nj``             ``tpu_program_energy_nj``
``OffloadDecision.gpu_ns``            ``OffloadDecision.tpu_ns``
``OffloadDecision.gpu_energy_nj``     ``OffloadDecision.tpu_energy_nj``
``winner`` / ``winner_energy``        the same, with ``"gpu"`` for
``== "gpu"``                          ``"tpu"``
====================================  ==================================

Planning is keyed by the shared
:class:`~repro_torch.backends.context.ExecutionContext`: the calibration
point (manufacturer, temperature, VPP) that fixes the retry counts comes
from the same object the execution backends run under.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.backends.context import ExecutionContext
from repro_torch.core import calibration as cal
from repro_torch.core import power as pw
from repro_torch.core.costmodel import (
    COST,
    HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    KERNEL_LAUNCH_NS as KERNEL_LAUNCH_NS,
    PEAK_FLOPS as PEAK_FLOPS,
)
from repro_torch.core.errormodel import ErrorModel, expected_retries
from repro_torch.pud import latency as lat


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    op: str
    n_bytes: int
    gpu_ns: float
    pud_ns: float
    winner: str
    detail: str
    #: Energy of each side (nJ, Fig. 5 power model on the PUD side; the
    #: CostModel's dispatch + HBM-access terms on the GPU side) and the
    #: side that wins on joules — which need not match ``winner``:
    #: offload can save energy even when it costs nanoseconds.
    gpu_energy_nj: float = 0.0
    pud_energy_nj: float = 0.0
    winner_energy: str = ""

    @property
    def speedup(self) -> float:
        return self.gpu_ns / self.pud_ns

    @property
    def energy_savings(self) -> float:
        """GPU-over-PUD energy ratio (>1: offloading saves joules)."""
        return self.gpu_energy_nj / self.pud_energy_nj


def _resolve(ctx: Optional[ExecutionContext],
             errors: Optional[ErrorModel]) -> tuple[ExecutionContext,
                                                    ErrorModel]:
    """One calibration point for both sides of the plan."""
    if ctx is None:
        ctx = ExecutionContext(mfr=errors.mfr if errors else "H")
    return ctx, errors if errors is not None else ctx.error_model


def gpu_bitwise_ns(n_bytes: int, n_operands: int = 2) -> float:
    """Bandwidth-bound cost of a bulk bitwise op on the GPU (read all
    operands + write result; the logic never binds)."""
    return COST.hbm_ns(n_bytes * (n_operands + 1))


def gpu_bitwise_energy_nj(n_bytes: int, n_operands: int = 2) -> float:
    """Energy of the same bulk bitwise op on the GPU: the DRAM access
    energy of streaming all operands + the result through HBM (like
    :func:`gpu_bitwise_ns`, launch overhead is excluded — bulk work
    amortizes it)."""
    return COST.hbm_energy_nj(n_bytes * (n_operands + 1))


def pud_majx_ns(n_bytes: int, x: int, n_act: int,
                errors: Optional[ErrorModel] = None, subarrays: int = 48,
                best_group: bool = True,
                ctx: Optional[ExecutionContext] = None) -> float:
    """PUD cost: ceil(bits/row_bits) MAJX issues spread over subarrays."""
    ctx, errors = _resolve(ctx, errors)
    if best_group:
        s = cal.MAJX_BEST_GROUP_SUCCESS[errors.mfr].get(x, 0.005)
    else:
        s = errors.majx_success(x, n_act, t1=ctx.timings.majx_t1,
                                t2=ctx.timings.majx_t2, **ctx.env())
    issues = -(-(n_bytes * 8) // lat.ROW_BITS)
    per = lat.LAT.majx_apa * expected_retries(s)
    waves = -(-issues // subarrays)
    return waves * per


def pud_majx_energy_nj(n_bytes: int, x: int, n_act: int,
                       errors: Optional[ErrorModel] = None,
                       subarrays: int = 48, best_group: bool = True,
                       ctx: Optional[ExecutionContext] = None) -> float:
    """Energy of the MAJX sweep: SiMRA power at ``n_act`` (Fig. 5 /
    Obs 5 — *below* REF at 32 rows) held for the retry-aware sweep
    time."""
    t = pud_majx_ns(n_bytes, x, n_act, errors, subarrays, best_group, ctx)
    return pw.simra_power_w(n_act) * t


def pud_mrc_ns(n_bytes: int, fanout: int,
               errors: Optional[ErrorModel] = None, subarrays: int = 48,
               ctx: Optional[ExecutionContext] = None) -> float:
    ctx, errors = _resolve(ctx, errors)
    s = errors.mrc_success(fanout, t1=ctx.timings.mrc_t1,
                           t2=ctx.timings.mrc_t2, **ctx.env())
    rows = -(-(n_bytes * 8) // lat.ROW_BITS)
    waves = -(-rows // subarrays)
    return waves * lat.LAT.mrc * expected_retries(s)


def pud_mrc_energy_nj(n_bytes: int, fanout: int,
                      errors: Optional[ErrorModel] = None,
                      subarrays: int = 48,
                      ctx: Optional[ExecutionContext] = None) -> float:
    """Energy of the MRC sweep: SiMRA power at the activation count
    (source + ``fanout`` destinations) over the retry-aware sweep time."""
    t = pud_mrc_ns(n_bytes, fanout, errors, subarrays, ctx)
    return pw.simra_power_w(fanout + 1) * t


def _dispatches_and_rows(program, fused: bool, sched) -> tuple[int, int]:
    from repro_torch.compile.schedule import VALUE_KINDS, build_schedule

    if sched is None:
        sched = build_schedule(program)
    dispatches = (sched.n_dispatches() if fused
                  else sched.per_op_dispatches())
    rows_moved = sum(len(op.srcs) + len(op.dsts) for op in program.ops
                     if op.dsts and op.kind in VALUE_KINDS)
    return dispatches, rows_moved


def gpu_program_ns(program, row_bytes: int, *, fused: bool = True,
                   sched=None) -> float:
    """GPU-side cost of executing an addressed Program's bulk ops.

    Bandwidth term: every value op moves ``len(srcs) + len(dsts)`` rows
    through HBM.  Launch term: one :data:`KERNEL_LAUNCH_NS` per kernel
    dispatch — the per-op interpreter launches one kernel per MAJ/MRC
    op, the fused path one per schedule dispatch group (see
    :mod:`repro_torch.compile.schedule`).  Pass a prebuilt ``sched`` to
    avoid re-leveling the program.
    """
    dispatches, rows_moved = _dispatches_and_rows(program, fused, sched)
    return (COST.dispatch_overhead(dispatches)
            + COST.hbm_ns(rows_moved * row_bytes))


def gpu_program_energy_nj(program, row_bytes: int, *, fused: bool = True,
                          sched=None) -> float:
    """GPU-side energy of the same execution: board power held across
    each kernel launch plus DRAM access energy for the rows moved."""
    dispatches, rows_moved = _dispatches_and_rows(program, fused, sched)
    return (COST.dispatch_energy_nj(dispatches)
            + COST.hbm_energy_nj(rows_moved * row_bytes))


def plan_program(program, row_bytes: int,
                 errors: Optional[ErrorModel] = None,
                 ctx: Optional[ExecutionContext] = None,
                 sched=None) -> OffloadDecision:
    """Where should a whole addressed Program run?

    Prices the PUD side with the program's retry-aware command schedule
    (:meth:`repro_torch.pud.isa.Program.latency_ns`) and the GPU side
    with the *fused* dispatch count, the executor the ``cuda`` backend
    uses by default.  Pass a prebuilt ``sched`` (e.g.
    ``DramSession.schedule_for``'s cached one) to avoid re-leveling the
    program.
    """
    from repro_torch.compile.schedule import build_schedule

    ctx, errors = _resolve(ctx, errors)
    if sched is None:
        sched = build_schedule(program)
    gpu = gpu_program_ns(program, row_bytes, fused=True, sched=sched)
    pud = program.latency_ns(errors, **ctx.env())
    gpu_e = gpu_program_energy_nj(program, row_bytes, fused=True,
                                  sched=sched)
    pud_e = program.energy_nj(errors, **ctx.env())
    n_ops = sum(1 for op in program.ops if op.dsts)
    return OffloadDecision(
        op=f"program[{n_ops}ops]", n_bytes=row_bytes, gpu_ns=gpu,
        pud_ns=pud, winner="pud" if pud < gpu else "gpu",
        detail=(f"gpu fused: {sched.n_dispatches()} dispatches over "
                f"{sched.n_levels} levels (vs {sched.per_op_dispatches()} "
                f"per-op); pud: retry-aware command schedule"),
        gpu_energy_nj=gpu_e, pud_energy_nj=pud_e,
        winner_energy="pud" if pud_e < gpu_e else "gpu",
    )


def plan_vote(n_bytes: int, x: int = 3, errors: ErrorModel | None = None,
              subarrays: int = 48,
              ctx: Optional[ExecutionContext] = None) -> OffloadDecision:
    """Where should an X-replica majority vote over ``n_bytes`` run?"""
    ctx, errors = _resolve(ctx, errors)
    gpu = gpu_bitwise_ns(n_bytes, n_operands=x)
    pud = pud_majx_ns(n_bytes, x, 32, errors, subarrays, ctx=ctx)
    gpu_e = gpu_bitwise_energy_nj(n_bytes, n_operands=x)
    pud_e = pud_majx_energy_nj(n_bytes, x, 32, errors, subarrays, ctx=ctx)
    return OffloadDecision(
        op=f"maj{x}_vote", n_bytes=n_bytes, gpu_ns=gpu, pud_ns=pud,
        winner="pud" if pud < gpu else "gpu",
        detail=(f"gpu reads {x}x+writes 1x @"
                f"{HBM_BYTES_PER_S / 1e12:g}TB/s; pud issues "
                f"{-(-(n_bytes*8)//lat.ROW_BITS)} MAJ{x} over {subarrays} "
                f"subarrays"),
        gpu_energy_nj=gpu_e, pud_energy_nj=pud_e,
        winner_energy="pud" if pud_e < gpu_e else "gpu",
    )


def plan_broadcast(n_bytes: int, fanout: int,
                   errors: ErrorModel | None = None,
                   subarrays: int = 48,
                   ctx: Optional[ExecutionContext] = None) -> OffloadDecision:
    """One-to-``fanout`` replication: HBM copies vs Multi-RowCopy."""
    ctx, errors = _resolve(ctx, errors)
    gpu = COST.hbm_ns(n_bytes * (1 + fanout))
    pud = pud_mrc_ns(n_bytes * fanout, min(fanout, 31), errors, subarrays,
                     ctx=ctx)
    gpu_e = COST.hbm_energy_nj(n_bytes * (1 + fanout))
    pud_e = pud_mrc_energy_nj(n_bytes * fanout, min(fanout, 31), errors,
                              subarrays, ctx=ctx)
    return OffloadDecision(
        op=f"broadcast_x{fanout}", n_bytes=n_bytes, gpu_ns=gpu, pud_ns=pud,
        winner="pud" if pud < gpu else "gpu",
        detail="MRC wipes/copies n_act-1 rows per 90ns issue",
        gpu_energy_nj=gpu_e, pud_energy_nj=pud_e,
        winner_energy="pud" if pud_e < gpu_e else "gpu",
    )
