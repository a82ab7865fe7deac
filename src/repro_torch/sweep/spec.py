"""Declarative sweep specifications: the paper's campaigns as data.

A characterization campaign in the SiMRA-DRAM paper is a cartesian grid:
operation x activation count x MAJ arity x data pattern x violated
timings x temperature x wordline voltage, repeated per chip (here: per
RNG seed / row-group identity) and — in this reproduction — per
execution backend.  :class:`SweepSpec` captures that grid declaratively;
everything downstream (planning, execution, storage, aggregation) is
derived from it, and the spec's content hash names the on-disk record
store so a restarted campaign resumes instead of recomputing.

Grid points that are physically invalid (e.g. MAJ5 with a 4-row
activation, which cannot hold five operands) are excluded at grid
construction time, mirroring the paper's own reachable-configuration
filtering (§4 Limitation 2).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Iterator

from repro_torch.core import calibration as cal

#: Operations a sweep can characterize.
OPS = ("majx", "mrc", "simra")

#: The pseudo-backend that evaluates the calibrated ErrorModel surface
#: directly instead of executing data through an executor — exact at the
#: paper's anchors and cheap enough for full figure grids.
ANALYTIC = "analytic"

#: Data patterns each op accepts (§3.1; MRC uses single-row patterns).
MAJX_PATTERNS = cal.DATA_PATTERNS
MRC_PATTERNS = ("random", "0x00", "0xFF")

_BEST_TIMINGS = {
    "majx": (cal.MAJX_BEST_T1_NS, cal.MAJX_BEST_T2_NS),
    "mrc": (cal.MRC_BEST_T1_NS, cal.MRC_BEST_T2_NS),
    "simra": (cal.SIMRA_BEST_T1_NS, cal.SIMRA_BEST_T2_NS),
}

#: Axes the adaptive boundary search (:mod:`repro_torch.sweep.adaptive`) can
#: bisect, mapped to the :class:`GridPoint` fields carrying their value.
#: ``timings`` is a joint (t1, t2) axis — one ladder position per pair —
#: and ``n_act`` also fixes the derived ``n_dest`` for ``mrc`` sweeps.
SEARCH_AXES = {
    "n_act": ("n_act", "n_dest"),
    "timings": ("t1", "t2"),
    "temp_c": ("temp_c",),
    "vpp_v": ("vpp_v",),
}


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One fully-resolved operating point of a sweep grid."""

    index: int
    op: str
    backend: str
    mfr: str
    x: int            # MAJ arity (0 for mrc/simra)
    n_act: int        # simultaneous-activation count
    n_dest: int       # Multi-RowCopy destinations (0 for majx/simra)
    pattern: str
    t1: float
    t2: float
    temp_c: float
    vpp_v: float
    seed: int

    def record_base(self) -> dict:
        """The point's identity as a flat JSON-able record prefix."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative characterization campaign (see module docstring).

    Axes (each a tuple; the grid is their cartesian product, filtered
    for physical validity):

    * ``backends`` — executor names from :mod:`repro_torch.backends`, or
      ``"analytic"`` for direct ErrorModel surface evaluation;
    * ``mfrs`` — manufacturer profiles (Table 1: "H"/"M"/"S");
    * ``x_values`` — MAJ arities (``majx`` only; ignored otherwise);
    * ``n_act`` — simultaneous-activation counts (``mrc`` copies to
      ``n_act - 1`` destinations, the paper's 1-source layout);
    * ``patterns`` — data patterns (op-specific vocabulary);
    * ``timings`` — (t1, t2) ns pairs; empty means the op's best point;
    * ``temps_c`` / ``vpps_v`` — environment;
    * ``seeds`` — chip / row-group identities (independent stable-cell
      masks in the ``sim`` backend).

    Trial geometry: each measured point executes ``rows`` independent
    row images of ``words`` uint32 words (``words * 32`` cells), the
    unit the per-point success rate is averaged over.
    """

    name: str
    op: str = "majx"
    backends: tuple[str, ...] = ("sim",)
    mfrs: tuple[str, ...] = ("H",)
    x_values: tuple[int, ...] = (3,)
    n_act: tuple[int, ...] = (32,)
    patterns: tuple[str, ...] = ("random",)
    timings: tuple[tuple[float, float], ...] = ()
    temps_c: tuple[float, ...] = (50.0,)
    vpps_v: tuple[float, ...] = (2.5,)
    seeds: tuple[int, ...] = (0,)

    rows: int = 2
    words: int = 16
    ideal: bool = False
    #: grid points per resumable execution chunk (the planner's unit).
    chunk: int = 8

    # ------------------------------------------------------------ validity
    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of {OPS}")
        vocab = MAJX_PATTERNS if self.op == "majx" else MRC_PATTERNS
        if self.op != "simra":
            bad = [p for p in self.patterns if p not in vocab]
            if bad:
                raise ValueError(f"invalid {self.op} patterns {bad}; "
                                 f"allowed: {vocab}")
        if self.op == "majx":
            for x in self.x_values:
                if x < 3 or x % 2 == 0:
                    raise ValueError(f"MAJX arity must be odd >= 3, got {x}")
        if self.op == "simra" and set(self.backends) != {ANALYTIC}:
            # Raw activation success has no executable digital analogue;
            # records must never claim a behavioural measurement here.
            raise ValueError(f"op='simra' is analytic-only; use "
                             f"backends=({ANALYTIC!r},)")
        # deferred: no import cycle
        from repro_torch.backends import available_backends
        known = set(available_backends()) | {ANALYTIC}
        bad_be = [b for b in self.backends if b not in known]
        if bad_be:
            raise ValueError(f"unknown backends {bad_be}; "
                             f"available: {sorted(known)}")
        for n in self.n_act:
            if n not in cal.N_ACT_LEVELS:
                raise ValueError(f"n_act={n} not reachable "
                                 f"(Limitation 2; levels {cal.N_ACT_LEVELS})")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")

    # ---------------------------------------------------------------- grid
    def _timings(self) -> tuple[tuple[float, float], ...]:
        return self.timings or (_BEST_TIMINGS[self.op],)

    def points(self) -> Iterator[GridPoint]:
        """Yield the valid grid points in a stable, documented order.

        Axis nesting (outer to inner): backend, mfr, x, n_act, pattern,
        timing, temp, vpp, seed.  Indices are assigned *after* validity
        filtering, so they are dense and stable for a given spec.
        """
        xs = self.x_values if self.op == "majx" else (0,)
        pats = self.patterns if self.op != "simra" else ("random",)
        idx = 0
        for be, mfr, x, n, pat, (t1, t2), tc, vv, sd in itertools.product(
                self.backends, self.mfrs, xs, self.n_act, pats,
                self._timings(), self.temps_c, self.vpps_v, self.seeds):
            if self.op == "majx" and n < cal.min_activation_for(x):
                continue  # cannot hold X operands (§3.3)
            n_dest = n - 1 if self.op == "mrc" else 0
            yield GridPoint(idx, self.op, be, mfr, x, n, n_dest, pat,
                            t1, t2, tc, vv, sd)
            idx += 1

    def n_points(self) -> int:
        return sum(1 for _ in self.points())

    def axis_values(self, axis: str) -> tuple:
        """The declared value ladder of one searchable axis, in spec
        order (the order the author arranged — by convention increasing
        stress / activation count; see :data:`SEARCH_AXES`)."""
        if axis == "n_act":
            return self.n_act
        if axis == "timings":
            return self._timings()
        if axis == "temp_c":
            return self.temps_c
        if axis == "vpp_v":
            return self.vpps_v
        raise ValueError(f"unknown search axis {axis!r}; "
                         f"expected one of {tuple(SEARCH_AXES)}")

    def searchable_axes(self) -> tuple[str, ...]:
        """Axes with more than one declared value (boundary-searchable)."""
        return tuple(a for a in SEARCH_AXES
                     if len(self.axis_values(a)) > 1)

    # ------------------------------------------------------------ identity
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        """A spec from its JSON; a reference spec's ``interpret`` key
        (its Pallas interpret flag, which the port has no use for) is
        discarded, so reference spec files load."""
        raw = json.loads(text)
        raw.pop("interpret", None)
        for k, v in raw.items():
            if isinstance(v, list):
                raw[k] = tuple(tuple(e) if isinstance(e, list) else e
                               for e in v)
        return cls(**raw)

    def spec_hash(self) -> str:
        """Content hash naming the record store (12 hex chars).

        Covers the grid *and* the calibrated physics: the fingerprint of
        :mod:`repro_torch.core.calibration` +
        :mod:`repro_torch.core.errormodel` is folded in, so editing an
        anchor or a surface invalidates every cached campaign instead of
        silently serving pre-change records.  Those are the port's own
        sources, so the hash differs from the reference package's even
        where the grids are identical.
        """
        payload = self.to_json() + "|model:" + _model_fingerprint()
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def store_name(self) -> str:
        return f"{self.name}-{self.spec_hash()}"

    def replace(self, **kw) -> "SweepSpec":
        return dataclasses.replace(self, **kw)


def _model_fingerprint() -> str:
    """Hash of the calibrated-physics sources records depend on.

    The port hashes the source text of its own ``core/calibration.py``
    and ``core/errormodel.py`` (the reference hashes its own two): the
    rule that an edit to an anchor or a surface orphans every store is
    kept, and no port store is ever named like a reference store.
    """
    import inspect

    from repro_torch.core import calibration, errormodel
    src = inspect.getsource(calibration) + inspect.getsource(errormodel)
    return hashlib.sha256(src.encode()).hexdigest()[:8]


def load_spec(path: str) -> SweepSpec:
    """Read a SweepSpec from a JSON file (the CLI's ``--spec``)."""
    with open(path) as f:
        return SweepSpec.from_json(f.read())
