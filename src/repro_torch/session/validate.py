"""Build-time program validation: fail before any kernel launches.

An addressed :class:`~repro_torch.pud.isa.Program` that references rows
outside its subarray image, or writes one destination row twice in a
single op, would otherwise fail *inside* an executing kernel — an
out-of-range gather on the card, a silently-wrong row image, or nothing
at all.  :func:`check_program` rejects malformed
programs up front with the op, its provenance tag, and the subarray
context in the message.

The checks themselves live in :func:`repro_torch.analyze.races.check_ops` —
the same structural pass the certifier runs — so session-layer
validation and :mod:`repro_torch.analyze` certification can never disagree
about what a well-formed program is.  This wrapper keeps the historical
raise-on-first-error contract: ``error`` findings raise
:class:`ProgramValidationError` (message of the first defect, full
list attached as ``findings``); ``warning`` findings (advisory
activation counts) never block execution.
"""

from __future__ import annotations

from repro_torch.analyze.races import check_ops
from repro_torch.analyze.report import ERROR, Finding
from repro_torch.pud.isa import Program
from repro_torch.session.rows import SessionError


class ProgramValidationError(SessionError):
    """An addressed Program failed build-time validation.

    ``findings`` carries every error-severity
    :class:`~repro_torch.analyze.report.Finding` of the failed pass, not just
    the first one the message shows.
    """

    def __init__(self, message: str, findings: tuple[Finding, ...] = ()):
        super().__init__(message)
        self.findings = findings


def check_program(program: Program, n_rows: int,
                  where: str = "program") -> None:
    """Validate every addressed op against an ``n_rows``-row subarray.

    Checks, per op with destinations (cost-only and I/O ops are exempt
    like in the scheduler): known op kind, all ``srcs``/``dsts`` inside
    ``[0, n_rows)``, no destination row written twice *within* the op,
    MAJ arity odd >= 3 with one source per operand plane (duplicate
    sources are legal — that is the paper's input-replication
    identity), and single-source kinds carrying exactly one source.
    """
    errors = tuple(f for f in check_ops(program, n_rows, where=where)
                   if f.severity == ERROR)
    if errors:
        raise ProgramValidationError(errors[0].message, findings=errors)
