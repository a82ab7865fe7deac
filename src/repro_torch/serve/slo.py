"""SLO observability: per-request traces, rolling percentiles, snapshots.

Serving is only as good as what it can prove about itself: the service
records a :class:`RequestTrace` of spans per request (queued ->
admitted -> batched -> executed) and the :class:`SloMonitor` folds
completions into rolling windows — p50/p99 latency, throughput, batch
occupancy, fused-dispatch counts — plus the schedule-cache hit rate
(windowed via :meth:`~repro_torch.session.cache.CacheStats.delta`) and a
per-session :class:`~repro_torch.ft.straggler.StragglerDetector` (one
"worker" per pooled ``DramSession``) that flags persistently slow
sessions exactly as the trainer flags slow SPMD workers.

:meth:`SloMonitor.snapshot` freezes everything into a structured
:class:`SloSnapshot` — the schema ``BENCH_serve.json`` embeds and
``docs/SERVING.md`` documents.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.ft.straggler import StragglerDetector
from repro_torch.session.cache import CacheStats


def _percentile(window, p: float) -> Optional[float]:
    if not window:
        return None
    return float(np.percentile(np.asarray(window, float), p))


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed stage of a request's lifecycle."""

    name: str
    start_s: float
    end_s: float

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclasses.dataclass
class RequestTrace:
    """Per-request span log (monotonic-clock timestamps)."""

    rid: int
    tenant: str
    kind: str
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    spans: list[Span] = dataclasses.field(default_factory=list)
    _open: dict[str, float] = dataclasses.field(default_factory=dict,
                                                repr=False)

    def begin(self, name: str) -> None:
        self._open[name] = time.monotonic()

    def end(self, name: str) -> None:
        start = self._open.pop(name, self.created_at)
        self.spans.append(Span(name, start, time.monotonic()))

    @property
    def latency_s(self) -> float:
        """created -> end of the last closed span."""
        if not self.spans:
            return 0.0
        return max(s.end_s for s in self.spans) - self.created_at

    def to_dict(self) -> dict:
        return {"rid": self.rid, "tenant": self.tenant, "kind": self.kind,
                "latency_s": self.latency_s,
                "spans": [{"name": s.name,
                           "duration_s": s.duration_s}
                          for s in self.spans]}


@dataclasses.dataclass(frozen=True)
class SloSnapshot:
    """Frozen view of the service's SLO counters (see module docstring)."""

    completed: int
    shed: int
    rejected: int
    batches: int
    dispatches: int
    #: CostModel-priced energy (nJ) the executing backends accrued across
    #: all recorded batches (kernel launches + HBM traffic on pallas;
    #: per-DRAM-command Fig. 5 energy on sim; 0 on oracle).
    energy_nj: float
    p50_latency_s: Optional[float]
    p99_latency_s: Optional[float]
    throughput_rps: float
    batch_occupancy: Optional[float]     # mean requests per executed batch
    cache: dict                          # {hits, misses, hit_rate} window
    tenants: dict
    slow_sessions: list[int]
    session_ema_s: list[float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SloMonitor:
    """Rolling SLO accounting for one :class:`PudService` (not
    thread-safe by itself — the service mutates it from its event loop
    only)."""

    def __init__(self, n_sessions: int, window: int = 512):
        self._n_sessions = max(n_sessions, 1)
        self._window = window
        self.reset()

    def reset(self, cache_stats: Optional[CacheStats] = None) -> None:
        """Zero every counter/window (bench warm-up exclusion).

        Passing the live cache stats also rebases the hit-rate window;
        the straggler EMAs restart cold.
        """
        self.started_at = time.monotonic()
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.batches = 0
        self.dispatches = 0
        self.energy_nj = 0.0
        self._latencies = collections.deque(maxlen=self._window)
        self._occupancy = collections.deque(maxlen=self._window)
        self.stragglers = StragglerDetector(n_workers=self._n_sessions)
        self._cache_mark = (cache_stats.snapshot() if cache_stats
                            else CacheStats())

    # ------------------------------------------------------------- recording
    def record_completion(self, trace: RequestTrace) -> None:
        self.completed += 1
        self._latencies.append(trace.latency_s)

    def record_shed(self) -> None:
        self.shed += 1

    def record_rejected(self) -> None:
        self.rejected += 1

    def record_batch(self, n_requests: int, wall_s: float,
                     dispatches: int, session_idx: int,
                     energy_nj: float = 0.0) -> None:
        self.batches += 1
        self.dispatches += dispatches
        self.energy_nj += energy_nj
        self._occupancy.append(float(n_requests))
        self.stragglers.record(session_idx, max(wall_s, 1e-9))

    # ------------------------------------------------------------- snapshot
    def snapshot(self, cache_stats: CacheStats,
                 tenants: Optional[dict] = None) -> SloSnapshot:
        elapsed = max(time.monotonic() - self.started_at, 1e-9)
        window = cache_stats.delta(self._cache_mark)
        return SloSnapshot(
            completed=self.completed,
            shed=self.shed,
            rejected=self.rejected,
            batches=self.batches,
            dispatches=self.dispatches,
            energy_nj=self.energy_nj,
            p50_latency_s=_percentile(self._latencies, 50),
            p99_latency_s=_percentile(self._latencies, 99),
            throughput_rps=self.completed / elapsed,
            batch_occupancy=(float(np.mean(self._occupancy))
                             if self._occupancy else None),
            cache={"hits": window.hits, "misses": window.misses,
                   "hit_rate": window.hit_rate},
            tenants=tenants or {},
            slow_sessions=self.stragglers.stragglers(),
            session_ema_s=[float(e) for e in self.stragglers.ema],
        )

    def rebase_cache_window(self, cache_stats: CacheStats) -> None:
        """Start a fresh cache-hit-rate window at the current counters."""
        self._cache_mark = cache_stats.snapshot()
