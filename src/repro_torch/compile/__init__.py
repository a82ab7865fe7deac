"""``repro_torch.compile``: program fusion for PUD instruction streams.

* :mod:`repro_torch.compile.schedule` — partition an addressed
  :class:`~repro_torch.pud.isa.Program` into hazard-respecting
  dependency levels and fuse each level's MAJX / Multi-RowCopy ops into
  single batched kernel dispatches;
* :mod:`repro_torch.compile.megakernel` — lower a whole Schedule to
  static level tables one kernel launch executes end-to-end.

Both are copies of the reference package's modules: schedules, tables
and digests are identical to it.
"""

from repro_torch.compile.megakernel import (MegaLowering, VmemPlan,
                                            lower_schedule, plan_vmem)
from repro_torch.compile.schedule import (FusedGroup, Schedule,
                                          build_schedule, dependency_levels)

__all__ = [
    "FusedGroup", "MegaLowering", "Schedule", "VmemPlan", "build_schedule",
    "dependency_levels", "lower_schedule", "plan_vmem",
]
