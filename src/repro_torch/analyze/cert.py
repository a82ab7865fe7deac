"""Certification driver: run every pass, emit a content-hashed Certificate.

:func:`certify` is the one entry point compiles go through: it runs the
race pass over the program, its fused schedule, and (when supplied) its
megakernel lowering, the liveness pass, and the symbolic equivalence
pass, then freezes the outcome into a :class:`Certificate` — a frozen,
JSON-able record whose ``digest`` covers the program content, the
artifact digests, the analyzer version, and the full pass summary.
Golden fixtures pin certificates byte-for-byte, and
:meth:`repro_torch.session.cache.CompileCache.certificate_for` memoizes them
under the program content key, so re-certifying a cached schedule is a
dictionary hit, not a re-analysis.

Any ``error``-severity finding raises :class:`CertificationError`
carrying the whole :class:`~repro_torch.analyze.report.AnalysisReport`;
warnings (dead ops, inferred inputs, advisory activation counts) are
counted in the certificate but do not block it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Optional

from repro_torch.analyze import equiv, liveness, races
from repro_torch.analyze.report import AnalysisReport
from repro_torch.compile.megakernel import MegaLowering
from repro_torch.compile.schedule import Schedule, build_schedule
from repro_torch.pud.isa import Program

#: Bump when a pass changes meaning: cached/golden certificates from
#: older analyzers must not satisfy newer gates.
ANALYZER_VERSION = 1

#: Error codes after which symbolic execution cannot run safely
#: (out-of-range indices would crash or silently wrap the exec arrays).
_RANGE_CODES = ("OP_ROW_RANGE", "TAB_SRC_RANGE", "TAB_DST_RANGE",
                "OP_UNKNOWN_KIND", "OP_MAJ_ARITY", "OP_MAJ_OPERANDS",
                "OP_SRC_COUNT")


class CertificationError(RuntimeError):
    """A compiled artifact failed static certification."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(report.render(limit=12))


def schedule_digest(sched: Schedule) -> str:
    """Content fingerprint of a Schedule's level/group/op structure."""
    h = hashlib.sha256()
    for lvl in sched.levels:
        for g in lvl:
            h.update(f"{g.kind}|{g.param}\n".encode())
            for op in g.ops:
                h.update(f"{op.kind}|{op.x}|{op.n_act}|{op.srcs}|"
                         f"{op.dsts}\n".encode())
        h.update(b"--\n")
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Frozen proof-of-analysis for one compiled program.

    ``summary`` is the deterministic (pass, errors, warnings) triple
    sequence of :meth:`~repro_torch.analyze.report.AnalysisReport.summary`;
    a certificate only exists when every error count is zero.
    ``lowering_digest`` is None when the program was certified for
    fused execution only — asking for megakernel certification later
    upgrades the cached entry (see ``CompileCache.certificate_for``).
    """

    program_key: str
    schedule_digest: str
    lowering_digest: Optional[str]
    n_ops: int
    n_rows: int
    n_levels: int
    summary: tuple[tuple[str, int, int], ...]
    analyzer_version: int = ANALYZER_VERSION

    @property
    def covers_lowering(self) -> bool:
        return self.lowering_digest is not None

    @property
    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(f"{self.program_key}|{self.schedule_digest}|"
                 f"{self.lowering_digest}|{self.n_ops}|{self.n_rows}|"
                 f"{self.n_levels}|v{self.analyzer_version}\n".encode())
        for name, errs, warns in self.summary:
            h.update(f"{name}:{errs}:{warns}\n".encode())
        return h.hexdigest()

    def to_dict(self) -> dict:
        """JSON form (golden ``certificate`` sections, CLI output)."""
        return {
            "digest": self.digest,
            "program_key": self.program_key,
            "schedule_digest": self.schedule_digest,
            "lowering_digest": self.lowering_digest,
            "n_ops": self.n_ops,
            "n_rows": self.n_rows,
            "n_levels": self.n_levels,
            "analyzer_version": self.analyzer_version,
            "passes": {name: {"errors": e, "warnings": w}
                       for name, e, w in self.summary},
        }


def analyze(program: Program, *, sched: Optional[Schedule] = None,
            lowering: Optional[MegaLowering] = None,
            n_rows: Optional[int] = None,
            inputs: Optional[Iterable[int]] = None,
            outputs: Optional[Iterable[int]] = None,
            where: str = "program") -> AnalysisReport:
    """Run every pass; never raises — inspect ``report.ok``.

    ``sched`` defaults to a fresh :func:`build_schedule` of the program
    (callers holding a cached schedule pass it to pin *that* artifact).
    ``lowering`` is analyzed only when given.  ``n_rows`` overrides the
    image height for range checks (defaults to the program's own).
    """
    report = AnalysisReport(subject=where)
    rows = n_rows if n_rows is not None else program.n_rows()
    report.extend(races.check_ops(program, rows, where=where))
    report.extend(liveness.liveness_findings(
        program, inputs=inputs, outputs=outputs, where=where))

    if sched is None:
        unsafe = {f.code for f in report.errors} & set(_RANGE_CODES)
        if not unsafe:
            sched = build_schedule(program)
    if sched is not None:
        report.extend(races.schedule_findings(sched, program, where=where))
    if lowering is not None:
        report.extend(races.lowering_findings(lowering, where=where))

    # Symbolic execution indexes arrays by the recorded rows — only
    # sound once every range/shape error class is clear.
    if not ({f.code for f in report.errors} & set(_RANGE_CODES)):
        report.extend(equiv.equivalence_findings(
            program, sched, lowering, where=where))
    return report


def certify(program: Program, *, sched: Optional[Schedule] = None,
            lowering: Optional[MegaLowering] = None,
            inputs: Optional[Iterable[int]] = None,
            outputs: Optional[Iterable[int]] = None,
            where: str = "program",
            key: Optional[str] = None) -> Certificate:
    """Analyze and, if clean, freeze a :class:`Certificate`.

    Raises :class:`CertificationError` (with the full report) on any
    error finding.  ``key`` optionally supplies a precomputed program
    content key to skip re-hashing.
    """
    from repro_torch.session.cache import program_key as _pk

    if sched is None:
        sched = build_schedule(program)
    report = analyze(program, sched=sched, lowering=lowering,
                     inputs=inputs, outputs=outputs, where=where)
    if not report.ok:
        raise CertificationError(report)
    return Certificate(
        program_key=key or _pk(program),
        schedule_digest=schedule_digest(sched),
        lowering_digest=lowering.digest() if lowering is not None else None,
        n_ops=len(program.ops),
        n_rows=program.n_rows(),
        n_levels=sched.n_levels,
        summary=report.summary())
