"""``repro_torch.serve``: the production service layer over PUD sessions.

The paper's headline capabilities — MAJX integrity voting (§5),
Multi-RowCopy healing/bulk-erase (§6/§8.2) — matter at production scale
only if many concurrent requests share the simultaneous-many-row
substrate efficiently.  This package is that service subsystem:

* :mod:`repro_torch.serve.queue` — typed ``IntegrityRequest`` /
  ``HealRequest`` / ``EraseRequest`` with priorities, deadlines,
  per-tenant accounting;
* :mod:`repro_torch.serve.admission` — per-tenant row arenas, bounded
  queues, backpressure, load-shedding;
* :mod:`repro_torch.serve.batcher` — continuous batching: same-shape
  requests coalesce into ONE fused Program per tick;
* :mod:`repro_torch.serve.slo` — request traces + rolling p50/p99/
  throughput/occupancy/cache-hit SLO snapshots;
* :mod:`repro_torch.serve.service` — :class:`PudService`, the engine
  tying them together over a pool of
  :class:`~repro_torch.session.DramSession`\\ s (on the card unless the
  context names another device).

:mod:`repro_torch.serve.engine` is the LM serving engine (continuous
batching over :mod:`repro_torch.models.model`), whose integrity hooks
``heal_params`` / ``verify_params`` are thin clients of
:class:`PudService`.
"""

from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionError,
                                         ArenaExhaustedError,
                                         DeadlineExceededError,
                                         QueueFullError, TenantArena)
from repro_torch.serve.batcher import Batcher, BatchOutcome, BatchPlan
from repro_torch.serve.queue import (EraseRequest, EraseResult,
                                     HealRequest, HealResult,
                                     IntegrityRequest, IntegrityResult,
                                     Priority, PudRequest, RequestQueue,
                                     ServeError)
from repro_torch.serve.service import PudService, ServiceConfig
from repro_torch.serve.slo import (RequestTrace, SloMonitor, SloSnapshot,
                                   Span)

__all__ = [
    "AdmissionController", "AdmissionError", "ArenaExhaustedError",
    "BatchOutcome", "BatchPlan", "Batcher", "DeadlineExceededError",
    "EraseRequest", "EraseResult", "HealRequest", "HealResult",
    "IntegrityRequest", "IntegrityResult", "Priority", "PudRequest",
    "PudService", "QueueFullError", "RequestQueue", "RequestTrace",
    "ServeError", "ServiceConfig", "SloMonitor", "SloSnapshot", "Span",
    "TenantArena",
]
