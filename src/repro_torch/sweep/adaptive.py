"""Adaptive boundary-search characterization: probe the cliff, skip the
plateau.

The paper's characterization surfaces (success rate vs. timing delay,
activation count, temperature, V_PP — Figs 5-12, Obs 6/9/11-18) are
smooth plateaus with sharp failure cliffs, so a dense grid wastes most
of its points far from the cliff.  :class:`AdaptiveSpec` wraps an
ordinary dense :class:`~repro_torch.sweep.spec.SweepSpec` and, per
(backend, mfr, arity, pattern, environment, seed) *slice*, bisects each
swept axis (``timings``, ``n_act``, ``temp_c``, ``vpp_v`` — see
:data:`repro_torch.sweep.spec.SEARCH_AXES`) for the success-rate threshold
crossings (e.g. 50 % and 90 %), then refines locally around each
bracket to ``refine_radius`` grid steps.

The crucial invariant: the adaptive mode never invents operating
points.  Every probe is a grid point of the wrapped dense spec,
executed as its ordinary planned chunk
(:func:`repro_torch.sweep.planner.chunks_by_point`) and persisted through the
*same* content-hashed :class:`~repro_torch.sweep.store.RecordStore` the dense
grid would use.  Consequences:

* records on points both modes touch are **byte-identical** (same
  chunk, same pure ``(spec, chunk) -> records`` executor, same
  serialization), so aggregates over overlapping points are provably
  identical between modes;
* an adaptive campaign kills/resumes exactly like a grid one: the
  search is deterministic, so a restart replays the same probe
  sequence, finds the already-stored chunks, and executes only what is
  missing;
* grid and adaptive runs of the same spec share one store — an
  adaptive pass is simply a cheap prefix of the dense campaign, and a
  later dense run fills in the rest without recomputing the cliff.

Point economy comes from the chunk granularity: set ``chunk=1`` (or
small) in the wrapped spec so a probe executes one point, not a stripe
of the grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.sweep import planner
from repro_torch.sweep.runner import _Executor
from repro_torch.sweep.spec import SEARCH_AXES, SweepSpec
from repro_torch.sweep.store import RecordStore, default_root

#: GridPoint fields that identify a search slice (everything but the
#: searched axis, whose fields come from SEARCH_AXES, and the dense
#: ``index``).
_POINT_FIELDS = ("op", "backend", "mfr", "x", "n_act", "n_dest", "pattern",
                 "t1", "t2", "temp_c", "vpp_v", "seed")


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """An adaptive campaign: a dense grid plus a boundary-search policy.

    ``thresholds`` are the success-rate levels whose crossings are
    located (paper-style: 0.5 = the cliff, 0.9 = the usable edge);
    ``axes`` restricts the search to specific swept axes (default:
    every axis of the base spec with more than one value);
    ``refine_radius`` probes that many extra grid steps on each side of
    a located bracket, mapping the local cliff shape; ``metric`` is the
    record field driving decisions (``success``, or ``expected`` to
    search the calibrated surface under a behavioural backend).
    """

    base: SweepSpec
    thresholds: tuple[float, ...] = (0.5, 0.9)
    axes: tuple[str, ...] = ()
    refine_radius: int = 1
    metric: str = "success"

    def __post_init__(self):
        if not self.thresholds:
            raise ValueError("need at least one threshold")
        for t in self.thresholds:
            if not 0.0 < t < 1.0:
                raise ValueError(f"thresholds must be in (0, 1), got {t}")
        for a in self.axes:
            if a not in SEARCH_AXES:
                raise ValueError(f"unknown search axis {a!r}; "
                                 f"expected one of {tuple(SEARCH_AXES)}")
            if len(self.base.axis_values(a)) < 2:
                raise ValueError(f"axis {a!r} is not swept by spec "
                                 f"{self.base.name!r} (needs >= 2 values)")
        if self.refine_radius < 0:
            raise ValueError("refine_radius must be >= 0")
        if self.metric not in ("success", "expected"):
            raise ValueError(f"metric must be 'success' or 'expected', "
                             f"got {self.metric!r}")

    def search_axes(self) -> tuple[str, ...]:
        return self.axes or self.base.searchable_axes()


@dataclasses.dataclass(frozen=True)
class Crossing:
    """One located threshold crossing (or its absence) on one slice.

    ``lo_index``/``hi_index`` are dense grid-point indices of the
    adjacent ladder positions bracketing the crossing (``lo`` earlier
    on the declared axis order); ``direction`` is ``"falling"`` when
    the metric drops below the threshold along the axis, ``"rising"``
    when it climbs above it, and ``None`` when the whole slice sits on
    one side (``crossed=False``).
    """

    axis: str
    threshold: float
    slice_key: tuple[tuple[str, object], ...]
    crossed: bool
    direction: Optional[str] = None
    lo_index: Optional[int] = None
    hi_index: Optional[int] = None
    lo_value: Optional[object] = None
    hi_value: Optional[object] = None

    def describe(self) -> str:
        if not self.crossed:
            return (f"{self.axis}@{self.threshold:g}: no crossing")
        return (f"{self.axis}@{self.threshold:g}: {self.direction} between "
                f"{self.lo_value} and {self.hi_value} "
                f"(points {self.lo_index}/{self.hi_index})")


@dataclasses.dataclass
class AdaptiveResult:
    """What one :func:`run_adaptive` invocation did and produced.

    ``n_probed`` counts distinct grid points the search consulted;
    ``points_covered`` counts points with records in the store after
    the run (>= ``n_probed`` when chunks hold several points, or when
    the store already held dense records).  ``complete`` is False when
    ``max_chunks`` exhausted the execution budget mid-search — re-run
    to resume with zero recomputation.
    """

    spec: AdaptiveSpec
    store_path: str
    n_grid_points: int
    n_probed: int
    points_covered: int
    executed_chunks: int
    cached_chunks: int
    crossings: list[Crossing]
    complete: bool
    records: list[dict]

    def summary(self) -> str:
        base = self.spec.base
        state = "" if self.complete else " [budget exhausted; resumable]"
        return (f"adaptive '{base.name}' [{base.spec_hash()}]: probed "
                f"{self.n_probed}/{self.n_grid_points} points "
                f"({self.executed_chunks} chunks executed, "
                f"{self.cached_chunks} cached), {len(self.crossings)} "
                f"crossings{state} at {self.store_path}")


class _Budget(Exception):
    """Internal: the max_chunks execution budget is exhausted."""


class _Prober:
    """Executes/loads grid points on demand through the shared store."""

    def __init__(self, aspec: AdaptiveSpec, store: RecordStore, mesh,
                 max_chunks: Optional[int], device: str):
        self.metric = aspec.metric
        self.store = store
        self.chunks = planner.plan(aspec.base)
        self.by_point = planner.chunks_by_point(self.chunks)
        self.executor = _Executor(aspec.base, mesh=mesh, device=device)
        self.max_chunks = max_chunks
        self.executed = 0
        self.probed: set[int] = set()
        # Resume: everything already in the store is a free probe.
        self.recs: dict[int, dict] = {r["index"]: r
                                      for r in self.store.records()}
        self.cached0 = len(self.store.completed())

    def probe(self, index: int) -> float:
        """Metric value at one dense grid point, executing its planned
        chunk if (and only if) the store does not hold it yet."""
        self.probed.add(index)
        if index not in self.recs:
            if (self.max_chunks is not None
                    and self.executed >= self.max_chunks):
                raise _Budget()
            chunk = self.by_point[index]
            records = self.executor.execute(chunk)
            self.store.put(chunk, records)
            self.executed += 1
            for r in records:
                self.recs[r["index"]] = r
        return float(self.recs[index][self.metric])


def _slices(spec: SweepSpec, axis: str
            ) -> dict[tuple, list[tuple[object, int]]]:
    """Per-slice ladders: slice key -> ordered [(axis value, index)].

    The ladder order is the spec's declared axis order (see
    :meth:`SweepSpec.axis_values`); positions the validity filter
    dropped (e.g. MAJ5 below its minimum activation) are simply absent.
    """
    fields = SEARCH_AXES[axis]
    values = list(spec.axis_values(axis))
    pos = {v: i for i, v in enumerate(values)}
    out: dict[tuple, list] = {}
    for p in spec.points():
        key = tuple((f, getattr(p, f)) for f in _POINT_FIELDS
                    if f not in fields)
        if axis == "timings":
            val = (p.t1, p.t2)
        elif axis == "n_act":
            val = p.n_act
        else:
            val = getattr(p, fields[0])
        out.setdefault(key, []).append((pos[val], val, p.index))
    return {k: [(v, i) for _, v, i in sorted(entries)]
            for k, entries in out.items()}


def _search_slice(prober: _Prober, aspec: AdaptiveSpec, axis: str,
                  slice_key: tuple, ladder: list[tuple[object, int]]
                  ) -> list[Crossing]:
    """Bisect one slice's ladder for every threshold crossing.

    Assumes the paper's plateau-cliff shape: the metric is treated as
    monotone along the axis between the endpoints, so bisection finds
    *the* crossing (on a non-monotone surface it finds *a* crossing).
    """
    m = len(ladder)
    s_first = prober.probe(ladder[0][1])
    s_last = prober.probe(ladder[-1][1])
    out = []
    for theta in aspec.thresholds:
        pred_first, pred_last = s_first >= theta, s_last >= theta
        if pred_first == pred_last:
            out.append(Crossing(axis=axis, threshold=theta,
                                slice_key=slice_key, crossed=False))
            continue
        lo, hi = 0, m - 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if (prober.probe(ladder[mid][1]) >= theta) == pred_first:
                lo = mid
            else:
                hi = mid
        # Local refinement: map the cliff shape around the bracket.
        for k in range(max(0, lo - aspec.refine_radius),
                       min(m, hi + 1 + aspec.refine_radius)):
            prober.probe(ladder[k][1])
        out.append(Crossing(
            axis=axis, threshold=theta, slice_key=slice_key, crossed=True,
            direction="falling" if pred_first else "rising",
            lo_index=ladder[lo][1], hi_index=ladder[hi][1],
            lo_value=ladder[lo][0], hi_value=ladder[hi][0]))
    return out


def run_adaptive(aspec: AdaptiveSpec, root: Optional[str] = None, *,
                 max_chunks: Optional[int] = None, mesh=None,
                 store: Optional[RecordStore] = None,
                 progress: bool = False,
                 device: str = "cuda") -> AdaptiveResult:
    """Run (or resume) an adaptive boundary-search campaign.

    The store is the wrapped dense spec's ordinary record store —
    adaptive and grid runs of the same spec are interchangeable
    consumers of it.  ``max_chunks`` bounds this invocation's chunk
    executions (kill simulation): the search stops mid-bisection and
    returns ``complete=False``; re-running resumes deterministically
    with zero recomputation.  ``device`` is where the probes execute.
    """
    spec = aspec.base
    if store is None:
        store = RecordStore(default_root(root), spec)
    prober = _Prober(aspec, store, mesh, max_chunks, device)
    crossings: list[Crossing] = []
    complete = True
    try:
        for axis in aspec.search_axes():
            for slice_key, ladder in _slices(spec, axis).items():
                if len(ladder) < 2:
                    continue  # nothing to bisect on this slice
                found = _search_slice(prober, aspec, axis, slice_key, ladder)
                crossings.extend(found)
                if progress:
                    for c in found:
                        print(f"[adaptive {spec.name}] {c.describe()}",
                              flush=True)
    except _Budget:
        complete = False

    return AdaptiveResult(
        spec=aspec, store_path=store.path, n_grid_points=spec.n_points(),
        n_probed=len(prober.probed), points_covered=len(prober.recs),
        executed_chunks=prober.executed, cached_chunks=prober.cached0,
        crossings=crossings, complete=complete,
        records=store.records())
