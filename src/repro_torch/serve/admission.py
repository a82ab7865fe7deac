"""Admission control: per-tenant row arenas, bounded queues, shedding.

A multi-tenant PUD service has two scarce resources: *subarray rows*
(every queued request will need operand/destination rows in some
session's subarray image) and *queue depth* (unbounded queues turn
overload into unbounded latency).  Admission charges both up front:

* each tenant owns a :class:`TenantArena` — a row budget enforced by a
  capacity-checked :class:`~repro_torch.session.rows.RowAllocator` whose
  reservations are released when the request completes (the allocator's
  free list is what lets a bounded budget admit an unbounded stream);
* queue depth is bounded globally and per tenant; a full queue is
  *backpressure* — :meth:`AdmissionController.admit` raises
  :class:`QueueFullError` and the caller either retries, waits, or
  surfaces the rejection to its own client.

Load-shedding is the third mechanism and happens at the *other* end of
the queue: the batching tick drops requests whose deadline has already
passed (:class:`DeadlineExceededError`), spending dispatch budget only
on work that can still meet its SLO.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.queue import PudRequest, RequestQueue, ServeError
from repro_torch.session.rows import (PlaneGroup, RowAllocationError,
                                      RowAllocator)


class AdmissionError(ServeError):
    """Request rejected at admission (backpressure)."""


class QueueFullError(AdmissionError):
    """Global or per-tenant queue depth bound hit."""


class ArenaExhaustedError(AdmissionError):
    """The tenant's subarray-row budget cannot hold the request."""


class DeadlineExceededError(ServeError):
    """Request load-shed: its deadline passed while it was queued."""


@dataclasses.dataclass
class TenantStats:
    """Per-tenant accounting, exposed in the SLO snapshot."""

    submitted: int = 0
    completed: int = 0
    shed: int = 0
    rejected: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class TenantArena:
    """One tenant's subarray-row budget.

    Rows are reserved through a capacity-checked
    :class:`~repro_torch.session.rows.RowAllocator` (the same build-time
    budget mechanism session programs use) and freed on completion.
    The arena's handles are accounting tokens — the batcher lays out
    each tick's actual subarray image with its own per-program
    allocator — so a stale arena handle can never alias an executing
    row.
    """

    def __init__(self, tenant: str, row_budget: int):
        self.tenant = tenant
        self.allocator = RowAllocator(row_budget,
                                      name=f"arena[{tenant}]")
        self.stats = TenantStats()

    @property
    def rows_in_use(self) -> int:
        return self.allocator.in_use

    def reserve(self, req: PudRequest) -> PlaneGroup:
        try:
            return self.allocator.alloc(
                max(req.rows_needed(), 1), tag=f"req[{req.rid}]")
        except RowAllocationError as e:
            raise ArenaExhaustedError(
                f"tenant {self.tenant!r}: {e} — request needs "
                f"{req.rows_needed()} rows") from e

    def release(self, reservation: PlaneGroup) -> None:
        self.allocator.free(reservation)


class AdmissionController:
    """Admit-or-reject gate in front of the request queue.

    ``admit`` validates depth bounds and reserves arena rows; it
    returns the reservation the service must hand back through
    ``release`` when the request completes (or is shed).  Unknown
    tenants get an arena lazily with the default row budget.
    """

    def __init__(self, queue: RequestQueue, *, tenant_rows: int = 4096,
                 tenant_queue_depth: Optional[int] = None):
        self.queue = queue
        self.tenant_rows = tenant_rows
        self.tenant_queue_depth = tenant_queue_depth
        self.arenas: dict[str, TenantArena] = {}

    def arena(self, tenant: str) -> TenantArena:
        if tenant not in self.arenas:
            self.arenas[tenant] = TenantArena(tenant, self.tenant_rows)
        return self.arenas[tenant]

    def admit(self, req: PudRequest) -> PlaneGroup:
        arena = self.arena(req.tenant)
        arena.stats.submitted += 1
        if self.queue.full:
            arena.stats.rejected += 1
            raise QueueFullError(
                f"service queue full ({self.queue.max_depth} requests); "
                f"request {req.rid} from tenant {req.tenant!r} rejected")
        depth_cap = self.tenant_queue_depth
        if depth_cap is not None and \
                self.queue.tenant_depth(req.tenant) >= depth_cap:
            arena.stats.rejected += 1
            raise QueueFullError(
                f"tenant {req.tenant!r} queue depth cap ({depth_cap}) "
                f"hit; request {req.rid} rejected")
        try:
            return arena.reserve(req)
        except ArenaExhaustedError:
            arena.stats.rejected += 1
            raise

    def release(self, req: PudRequest, reservation: PlaneGroup, *,
                shed: bool = False) -> None:
        arena = self.arena(req.tenant)
        arena.release(reservation)
        if shed:
            arena.stats.shed += 1
        else:
            arena.stats.completed += 1

    def tenant_snapshot(self) -> dict[str, dict]:
        return {t: {"rows_in_use": a.rows_in_use,
                    "row_budget": a.allocator.capacity,
                    **a.stats.to_dict()}
                for t, a in sorted(self.arenas.items())}
