"""Static analysis of PUD programs and their compiled artifacts.

Three passes over the compile pipeline's three artifact forms
(:class:`~repro_torch.pud.isa.Program` op streams, fused
:class:`~repro_torch.compile.schedule.Schedule` levels, megakernel
:class:`~repro_torch.compile.megakernel.MegaLowering` slot tables):

* **races** (:mod:`repro_torch.analyze.races`) — structural op validation
  plus intra-level RAW/WAW hazards and slot-table safety (constant-row
  writes, trash-row reads, conflicting scatters);
* **liveness** (:mod:`repro_torch.analyze.liveness`) — per-row lifetime
  intervals, dead ops, inferred inputs, and
  :class:`~repro_torch.session.rows.RowAllocator` audits (use-after-free,
  leaks);
* **equivalence** (:mod:`repro_torch.analyze.equiv`) — symbolic execution
  over a hash-consed term algebra proving schedule and level tables
  compute exactly the source program's dataflow (including the MAJ
  arity-padding and MRC/COPY/NOT expansion identities).

:func:`certify` drives all three and freezes a content-hashed
:class:`Certificate`; :class:`~repro_torch.session.cache.CompileCache`
memoizes certificates so every :class:`~repro_torch.session.DramSession`
execution is certified at one-analysis-per-program-content cost.
The seeded-mutation negative gate is :mod:`repro_torch.analyze.mutate`.

Every pass is pure Python over the artifacts' integers and numpy
tables (no tensor, no device), copied from the reference package so
that reports, summaries and certificate digests are byte-identical to
it.
"""

from repro_torch.analyze.cert import (ANALYZER_VERSION, Certificate,
                                      CertificationError, analyze, certify,
                                      schedule_digest)
from repro_torch.analyze.equiv import (SymbolicDomain, equivalence_findings,
                                       exec_lowering, exec_program,
                                       exec_schedule)
from repro_torch.analyze.liveness import (RowLifetime, allocator_findings,
                                          lifetimes, liveness_findings)
from repro_torch.analyze.mutate import MUTATIONS, apply_mutation
from repro_torch.analyze.races import (check_ops, iter_level_ops,
                                       lowering_findings, schedule_findings)
from repro_torch.analyze.report import (ERROR, WARNING, AnalysisReport,
                                        Finding)

__all__ = [
    "ANALYZER_VERSION", "AnalysisReport", "Certificate",
    "CertificationError", "ERROR", "Finding", "MUTATIONS", "RowLifetime",
    "SymbolicDomain", "WARNING", "allocator_findings", "analyze",
    "apply_mutation", "certify", "check_ops", "equivalence_findings",
    "exec_lowering", "exec_program", "exec_schedule", "iter_level_ops",
    "lifetimes", "liveness_findings", "lowering_findings",
    "schedule_digest", "schedule_findings",
]
