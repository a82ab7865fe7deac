"""PUD instruction stream: the compilation target of the bit-serial compiler.

Every §8.1 microbenchmark lowers to a stream of :class:`PUDOp` (MAJX issues,
row copies, Frac inits, NOTs-via-complement-copy).  The stream is both
executable (logical backend in :mod:`repro_torch.pud.arith`, device backend in
:mod:`repro_torch.pud.device`) and costable (:mod:`repro_torch.pud.latency`), which is
how the Fig. 16 / Fig. 17 benchmarks derive execution time from the same
program the correctness tests run.
"""

from __future__ import annotations

import collections
import dataclasses
import json

from repro_torch.core.costmodel import COST
from repro_torch.core.errormodel import ErrorModel


@dataclasses.dataclass(frozen=True)
class PUDOp:
    kind: str          # MAJ | NOT | COPY | MRC | FRAC | WR | RD
    x: int = 0         # majority arity (MAJ only)
    n_act: int = 0     # simultaneous activation count (MAJ/MRC)
    tag: str = ""      # provenance (e.g. "add/carry[7]")
    #: Row addresses, making the stream *executable* by any registered
    #: backend (repro_torch.backends): MAJ reads the X distinct operand rows in
    #: ``srcs`` and writes ``dsts``; COPY/NOT/MRC read ``srcs[0]`` and
    #: write every row in ``dsts``; FRAC neutral-inits ``dsts``.  Programs
    #: recorded purely for costing leave both empty.
    srcs: tuple[int, ...] = ()
    dsts: tuple[int, ...] = ()


@dataclasses.dataclass
class Program:
    ops: list[PUDOp] = dataclasses.field(default_factory=list)

    def emit(self, kind: str, x: int = 0, n_act: int = 0, tag: str = "",
             srcs: tuple[int, ...] = (), dsts: tuple[int, ...] = ()) -> None:
        self.ops.append(PUDOp(kind, x, n_act, tag, tuple(srcs), tuple(dsts)))

    def extend(self, other: "Program") -> None:
        self.ops.extend(other.ops)

    def n_rows(self) -> int:
        """Rows an executing backend must hold (max address + 1)."""
        mx = -1
        for op in self.ops:
            for r in op.srcs + op.dsts:
                mx = max(mx, r)
        return mx + 1

    def histogram(self) -> dict[tuple, int]:
        h: dict[tuple, int] = collections.Counter()
        for op in self.ops:
            h[(op.kind, op.x, op.n_act)] += 1
        return dict(h)

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        """Canonical JSON form (golden-program regression fixtures)."""
        return json.dumps([dataclasses.asdict(op) for op in self.ops])

    @classmethod
    def from_json(cls, text: str) -> "Program":
        prog = cls()
        for raw in json.loads(text):
            prog.emit(raw["kind"], x=raw["x"], n_act=raw["n_act"],
                      tag=raw["tag"], srcs=tuple(raw["srcs"]),
                      dsts=tuple(raw["dsts"]))
        return prog

    # ------------------------------------------------------------- costing
    def latency_ns(
        self, errors: ErrorModel, *, pipelined: bool = False,
        best_group: bool = False, **env,
    ) -> float:
        """Expected execution time with retry-until-success semantics.

        ``pipelined=True`` drops operand staging (RowClone/Frac setup) from
        MAJ issues — the steady-state cost when operands already live in the
        subarray, as in the paper's tightly-scheduled §8.1 programs.
        ``best_group=True`` uses the best-row-group success rates the case
        studies select (calibration.MAJX_BEST_GROUP_SUCCESS).

        Delegates to the shared :data:`repro_torch.core.costmodel.COST` — the
        same model that prices the TPU side of offload decisions.
        """
        return COST.program_latency_ns(self, errors, pipelined=pipelined,
                                       best_group=best_group, **env)

    def energy_nj(self, errors: ErrorModel, **env) -> float:
        """Energy from the Fig.-5 power model over the schedule (W x ns =
        nJ; delegates to :data:`repro_torch.core.costmodel.COST`)."""
        return COST.program_energy_nj(self, errors, **env)
