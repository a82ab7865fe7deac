"""Findings and reports: the shared result vocabulary of the analyzer.

Every analysis pass (:mod:`repro_torch.analyze.races`,
:mod:`repro_torch.analyze.liveness`, :mod:`repro_torch.analyze.equiv`) emits
:class:`Finding` records instead of raising — so one run can report
*all* defects of an artifact, and the driver (:func:`repro_torch.analyze.cert.
certify`) decides what is fatal.  ``error`` findings block
certification; ``warning`` findings are advisory (dead ops, inferred
inputs, physically questionable activation counts) and are recorded in
the :class:`~repro_torch.analyze.cert.Certificate` pass summary without
failing it.

Codes are stable strings (``RACE_*`` / ``LIVE_*`` / ``EQ_*``) so tests
and CI gates assert on *which* defect was found, not on message
wording.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect (or advisory observation) in one analyzed artifact.

    ``where`` names the artifact region: an op index for program-level
    findings, ``level L / slot W`` for table-level ones, a row index
    for liveness intervals.  ``code`` is the stable machine-readable
    defect class; ``message`` the human explanation.
    """

    pass_name: str          # "race" | "liveness" | "equivalence"
    severity: str           # ERROR | WARNING
    code: str               # stable defect class, e.g. "RACE_WAW_LEVEL"
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        return f"[{self.severity}] {self.code}{loc}: {self.message}"


@dataclasses.dataclass
class AnalysisReport:
    """All findings of one analysis run, queryable by severity/pass."""

    subject: str = "program"
    findings: list[Finding] = dataclasses.field(default_factory=list)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """True when nothing blocks certification (warnings allowed)."""
        return not self.errors

    def by_pass(self, pass_name: str) -> list[Finding]:
        return [f for f in self.findings if f.pass_name == pass_name]

    def summary(self) -> tuple[tuple[str, int, int], ...]:
        """Deterministic (pass, n_errors, n_warnings) triples.

        The shape frozen into golden-fixture ``certificate`` sections:
        passes appear in canonical order even when clean, so a pass
        silently not running changes the summary (and the digest).
        """
        order = ("race", "liveness", "equivalence")
        extra = sorted({f.pass_name for f in self.findings} - set(order))
        out = []
        for name in (*order, *extra):
            errs = sum(1 for f in self.findings
                       if f.pass_name == name and f.severity == ERROR)
            warns = sum(1 for f in self.findings
                        if f.pass_name == name and f.severity == WARNING)
            out.append((name, errs, warns))
        return tuple(out)

    def render(self, limit: Optional[int] = None) -> str:
        lines = [f"{self.subject}: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        shown = self.findings if limit is None else self.findings[:limit]
        lines.extend(f"  {f}" for f in shown)
        if limit is not None and len(self.findings) > limit:
            lines.append(f"  ... {len(self.findings) - limit} more")
        return "\n".join(lines)
