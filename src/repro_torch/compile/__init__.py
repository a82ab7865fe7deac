"""``repro_torch.compile``: program fusion for PUD instruction streams.

* :mod:`repro_torch.compile.schedule` — partition an addressed
  :class:`~repro_torch.pud.isa.Program` into hazard-respecting
  dependency levels and fuse each level's MAJX / Multi-RowCopy ops into
  single batched kernel dispatches;
* :mod:`repro_torch.compile.megakernel` — lower a whole Schedule to
  static level tables one kernel launch executes end-to-end;
* :mod:`repro_torch.compile.trace` — trace a §8.1 bit-serial gate
  stream into an addressed Program and its initial image
  (:func:`compile_elementwise`, exact for the operands it traced), or
  compile an op once for any operands (:func:`compile_op`).

The first two are copies of the reference package's modules: schedules,
tables and digests are identical to it.  The tracer keys rows by a
digest of each plane's bytes, and gives the reference's Program, image
and output rows.
"""

from repro_torch.compile.megakernel import (MegaLowering, VmemPlan,
                                            lower_schedule, plan_vmem)
from repro_torch.compile.schedule import (FusedGroup, Schedule,
                                          build_schedule, dependency_levels)
from repro_torch.compile.trace import (CompiledOp, CompiledProgram, Tracer,
                                       compile_elementwise, compile_op,
                                       trace_planes)

__all__ = [
    "CompiledOp", "CompiledProgram", "FusedGroup", "MegaLowering",
    "Schedule", "Tracer", "VmemPlan", "build_schedule",
    "compile_elementwise", "compile_op",
    "dependency_levels", "lower_schedule", "plan_vmem", "trace_planes",
]
