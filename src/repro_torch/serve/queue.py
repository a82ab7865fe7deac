"""Typed PUD service requests and the priority request queue.

The serve layer's unit of work is a *request*: a tenant asking for one
of the paper's three production capabilities — an integrity check
(bit-level mismatch of a live tile vs a reference), a MAJX heal
(majority vote across replica tiles, §5), or a Multi-RowCopy bulk erase
(§8.2).  Requests are plain dataclasses over packed uint32 bit-plane
tiles (the layout of :mod:`repro_torch.core.bitplanes`), carry priority /
deadline / tenant metadata, and expose the two properties the service
machinery keys on:

* :meth:`PudRequest.coalesce_key` — requests with equal keys can be
  fused into ONE addressed Program per batching tick (see
  :mod:`repro_torch.serve.batcher`);
* :meth:`PudRequest.rows_needed` — the subarray-row footprint admission
  control charges against the tenant's arena
  (:mod:`repro_torch.serve.admission`).

:class:`RequestQueue` is the bounded priority queue between
``PudService.submit`` and the batching loop: strict priority order,
FIFO within a priority, per-tenant accounting, and O(1) depth checks
for backpressure.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Optional

import numpy as np
import torch


class ServeError(RuntimeError):
    """Base error of the serve layer."""


class Priority(enum.IntEnum):
    """Dispatch priority; lower value dequeues first."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


def _as_tile(arr, what: str, ndim: int) -> np.ndarray:
    if arr is None:
        raise ServeError(f"{what} is required")
    out = np.asarray(arr, np.uint32)
    if out.ndim != ndim:
        raise ServeError(
            f"{what} must be a rank-{ndim} packed uint32 tile, got "
            f"shape {out.shape}")
    return out


@dataclasses.dataclass
class PudRequest:
    """Base request: tenant + QoS metadata (see module docstring).

    ``deadline_s`` is relative to submission; past-deadline requests
    still queued at a batching tick are load-shed (the future raises
    :class:`~repro_torch.serve.admission.DeadlineExceededError`).
    ``rid``, ``submitted_at`` and ``deadline_at`` are stamped by the
    service at admission.
    """

    tenant: str = "default"
    priority: Priority = Priority.NORMAL
    deadline_s: Optional[float] = None
    rid: int = dataclasses.field(default=-1, compare=False)
    submitted_at: float = dataclasses.field(default=0.0, compare=False)
    deadline_at: Optional[float] = dataclasses.field(
        default=None, compare=False)

    @property
    def kind(self) -> str:
        return type(self).__name__.removesuffix("Request").lower()

    def coalesce_key(self) -> tuple:
        raise NotImplementedError

    def rows_needed(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class IntegrityRequest(PudRequest):
    """Bit-level verification: live tile vs reference tile.

    Executed as one ``mismatch`` bulk op per request (a scalar
    reduction has no per-request split, so integrity work shares the
    tick and the session pool but not a fused Program).  Result:
    :class:`IntegrityResult`.
    """

    live: Optional[np.ndarray] = None          # required; validated below
    reference: Optional[np.ndarray] = None     # required; validated below

    def __post_init__(self):
        self.live = _as_tile(self.live, "IntegrityRequest.live", 2)
        self.reference = _as_tile(
            self.reference, "IntegrityRequest.reference", 2)
        if self.live.shape != self.reference.shape:
            raise ServeError(
                f"live tile {self.live.shape} != reference tile "
                f"{self.reference.shape}")

    def coalesce_key(self) -> tuple:
        return ("verify", int(self.live.shape[1]))

    def rows_needed(self) -> int:
        return 2 * int(self.live.shape[0])


@dataclasses.dataclass
class HealRequest(PudRequest):
    """X-replica majority-vote heal over packed plane tiles.

    ``replicas``: ``(x, rows, words)`` uint32, ``x`` odd >= 3.  All
    same-``(x, words, n_act)`` heal requests in a tick coalesce into one
    single-level fused Program — one batched MAJX dispatch for every
    tenant's vote.  Result: :class:`HealResult`.
    """

    replicas: Optional[np.ndarray] = None      # required; validated below
    n_act: Optional[int] = None

    def __post_init__(self):
        self.replicas = _as_tile(self.replicas, "HealRequest.replicas", 3)
        x = int(self.replicas.shape[0])
        if x % 2 == 0 or x < 3:
            raise ServeError(
                f"HealRequest needs an odd replica count >= 3, got {x}")

    @property
    def x(self) -> int:
        return int(self.replicas.shape[0])

    @property
    def rows(self) -> int:
        return int(self.replicas.shape[1])

    def coalesce_key(self) -> tuple:
        return ("heal", self.x, int(self.replicas.shape[2]), self.n_act)

    def rows_needed(self) -> int:
        return (self.x + 1) * self.rows  # x input groups + voted output


@dataclasses.dataclass
class EraseRequest(PudRequest):
    """§8.2 Multi-RowCopy bulk erase of ``rows`` x ``words`` planes.

    One WR'd pattern row fans out in waves of ``fanout`` destinations;
    all same-``(words, pattern, fanout)`` erases in a tick share a
    single pattern row and coalesce into one single-level fused
    Program.  Result: :class:`EraseResult`.
    """

    rows: int = 0
    words: int = 0
    pattern: int = 0
    fanout: int = 31

    def __post_init__(self):
        if self.rows < 1 or self.words < 1:
            raise ServeError(
                f"EraseRequest needs rows >= 1 and words >= 1, got "
                f"rows={self.rows} words={self.words}")
        if not 1 <= self.fanout <= 31:
            raise ServeError(
                f"EraseRequest fanout must be in 1..31 (n_act <= 32), "
                f"got {self.fanout}")

    def coalesce_key(self) -> tuple:
        return ("erase", self.words, int(np.uint32(self.pattern)),
                self.fanout)

    def rows_needed(self) -> int:
        return self.rows  # the shared pattern row is charged to no tenant


# ---------------------------------------------------------------- results


@dataclasses.dataclass(frozen=True)
class IntegrityResult:
    mismatch_bits: int
    total_bits: int

    @property
    def success_rate(self) -> float:
        return 1.0 - self.mismatch_bits / max(self.total_bits, 1)


# ``healed`` and ``wiped`` are int32 tensors on the executing session's
# device holding the uint32 bit patterns (the port's packed-word
# convention); ``repro_torch.core.bitplanes.to_u32`` gives the numpy.


@dataclasses.dataclass(frozen=True)
class HealResult:
    healed: torch.Tensor        # (rows, words) voted tile
    fixed_bits: int             # bits corrected vs replica 0
    decision: object = None     # OffloadDecision for the fused program


@dataclasses.dataclass(frozen=True)
class EraseResult:
    wiped: torch.Tensor         # (rows, words), pattern everywhere


# ------------------------------------------------------------------ queue


class RequestQueue:
    """Bounded strict-priority FIFO with per-tenant depth accounting.

    Pure data structure: admission policy (what *gets* to be pushed)
    lives in :mod:`repro_torch.serve.admission`; asynchrony (waiting for
    space / for work) lives in
    :class:`~repro_torch.serve.service.PudService`.
    """

    def __init__(self, max_depth: int = 256):
        self.max_depth = max_depth
        self._heap: list[tuple[int, int, PudRequest]] = []
        self._seq = itertools.count()
        self._tenant_depth: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.max_depth

    def tenant_depth(self, tenant: str) -> int:
        return self._tenant_depth.get(tenant, 0)

    def push(self, req: PudRequest) -> None:
        if self.full:
            raise ServeError(
                f"queue full ({self.max_depth}); admission should have "
                f"rejected request {req.rid} first")
        heapq.heappush(self._heap, (int(req.priority), next(self._seq), req))
        self._tenant_depth[req.tenant] = self.tenant_depth(req.tenant) + 1

    def pop(self) -> PudRequest:
        _, _, req = heapq.heappop(self._heap)
        self._tenant_depth[req.tenant] -= 1
        return req

    def drain(self, max_requests: Optional[int] = None) -> list[PudRequest]:
        """Dequeue up to ``max_requests`` in priority-then-FIFO order."""
        n = len(self._heap) if max_requests is None else \
            min(max_requests, len(self._heap))
        return [self.pop() for _ in range(n)]
