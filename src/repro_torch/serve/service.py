"""PudService: the multi-tenant continuous-batching PUD engine.

One service owns everything a production integrity/erase workload
needs, end to end:

* a **pool of sessions** — ``pool_size`` :class:`~repro_torch.session.
  DramSession`\\ s over one backend choice (``cuda`` on the card by
  default), all sharing ONE :class:`~repro_torch.session.cache.
  CompileCache` (a schedule is a pure content function, so every pooled
  session benefits from every other session's compiles);
* an **async request queue** — typed requests (:mod:`repro_torch.serve.
  queue`) admitted through per-tenant row arenas and bounded-depth
  backpressure (:mod:`repro_torch.serve.admission`);
* **continuous batching** — each tick drains the queue in priority
  order, load-sheds past-deadline work, and coalesces same-shape
  requests into one fused Program per group (:mod:`repro_torch.serve.
  batcher`), so N tenants' votes cost one schedule-cache lookup and one
  batched dispatch set;
* **SLO observability** — per-request traces and a rolling
  :class:`~repro_torch.serve.slo.SloMonitor` snapshot (latency
  percentiles, throughput, occupancy, cache hit rate, straggler
  sessions).  A batch's wall ends when the session's device has
  finished the batch: kernel launches are asynchronous, so on a CUDA
  device the tick synchronizes it before reading the clock.

Two client styles share one engine:

>>> svc = PudService(ServiceConfig(pool_size=2))       # the card
>>> [res] = svc.serve([HealRequest(replicas=tiles)])   # sync clients
>>> async def client():                                # async clients
...     await svc.start()
...     res = await svc.submit(HealRequest(replicas=tiles))
...     await svc.stop()

The LM serving engine (:mod:`repro_torch.serve.engine`) is a thin sync
client of this service: its ``heal_params`` / ``verify_params`` submit
one heal or integrity request over the model's packed parameters.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Callable, Optional, Union

import torch

from repro_torch.backends import Backend, ExecutionContext
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionError,
                                         DeadlineExceededError)
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.queue import PudRequest, RequestQueue
from repro_torch.serve.slo import RequestTrace, SloMonitor, SloSnapshot
from repro_torch.session import CompileCache, DramSession


@dataclasses.dataclass
class ServiceConfig:
    """Service-level knobs (execution-regime knobs stay in ``ctx``).

    ``ctx`` defaults to an *ideal* context: integrity votes must be
    error-free, so a stochastic backend may only be configured
    explicitly (fidelity studies), mirroring the serve engine's rule.
    """

    backend: Union[str, Backend] = "cuda"
    ctx: Optional[ExecutionContext] = None
    pool_size: int = 2
    max_batch: int = 64           # requests drained per tick
    coalesce: bool = True         # False = sequential baseline
    queue_depth: int = 256        # global backpressure bound
    tenant_queue_depth: Optional[int] = None
    tenant_rows: int = 4096       # per-tenant arena row budget
    tick_window_s: float = 0.0    # extra coalescing wait before ticking
                                  # (honored by serve() and the async loop)
    shed_late: bool = True        # drop past-deadline work at tick time
    latency_window: int = 512     # rolling SLO window (completions)


def _finish(session: DramSession) -> None:
    """Wait until ``session``'s device has run everything launched so
    far (a no-op on the CPU, where every op has already run)."""
    device = session.backend.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _Pending:
    req: PudRequest
    reservation: object
    trace: RequestTrace
    deliver: Callable[[object, Optional[BaseException]], None]


class PudService:
    """See module docstring.  Single-threaded: ticks run either inline
    (:meth:`serve`, :meth:`tick`) or on the asyncio event loop
    (:meth:`start` / :meth:`submit`); the shared compile cache is the
    one structure that is also safe under true thread concurrency."""

    def __init__(self, cfg: Optional[ServiceConfig] = None, *,
                 cache: Optional[CompileCache] = None):
        self.cfg = cfg or ServiceConfig()
        ctx = self.cfg.ctx or ExecutionContext(ideal=True)
        self.cache = cache if cache is not None else CompileCache()
        self.sessions = [
            DramSession(self.cfg.backend, ctx, cache=self.cache,
                        name=f"serve-pud[{i}]")
            for i in range(max(self.cfg.pool_size, 1))
        ]
        self.queue = RequestQueue(self.cfg.queue_depth)
        self.admission = AdmissionController(
            self.queue, tenant_rows=self.cfg.tenant_rows,
            tenant_queue_depth=self.cfg.tenant_queue_depth)
        self.batcher = Batcher(self.cfg.coalesce)
        self.slo = SloMonitor(len(self.sessions),
                              window=self.cfg.latency_window)
        self._pending: dict[int, _Pending] = {}
        self._rid = itertools.count()
        self._rr = 0
        self._task: Optional[asyncio.Task] = None
        self._wakeup: Optional[asyncio.Event] = None
        self._running = False

    @property
    def ctx(self) -> ExecutionContext:
        return self.sessions[0].ctx

    # ------------------------------------------------------------ admission
    def _enqueue(self, req: PudRequest,
                 deliver: Callable[[object, Optional[BaseException]], None]
                 ) -> int:
        """Admit + queue one request; raises AdmissionError on rejection."""
        req.rid = next(self._rid)
        req.submitted_at = time.monotonic()
        if req.deadline_s is not None:
            req.deadline_at = req.submitted_at + req.deadline_s
        trace = RequestTrace(req.rid, req.tenant, req.kind)
        trace.begin("queued")
        try:
            reservation = self.admission.admit(req)
        except AdmissionError:
            self.slo.record_rejected()
            raise
        self.queue.push(req)
        self._pending[req.rid] = _Pending(req, reservation, trace, deliver)
        return req.rid

    # ------------------------------------------------------------- batching
    def tick(self) -> int:
        """One batching tick: drain -> shed -> coalesce -> execute.

        Synchronous (the async loop calls it too); returns completions.
        """
        drained = self.queue.drain(self.cfg.max_batch)
        now = time.monotonic()
        live: list[_Pending] = []
        for req in drained:
            pend = self._pending.pop(req.rid)
            pend.trace.end("queued")
            if (self.cfg.shed_late and req.deadline_at is not None
                    and now > req.deadline_at):
                self.admission.release(req, pend.reservation, shed=True)
                self.slo.record_shed()
                pend.deliver(None, DeadlineExceededError(
                    f"request {req.rid} (tenant {req.tenant!r}) shed: "
                    f"deadline passed {now - req.deadline_at:.3f}s before "
                    f"its batching tick"))
                continue
            live.append(pend)
        by_rid = {p.req.rid: p for p in live}
        completed = 0
        for plan in self.batcher.plan([p.req for p in live]):
            idx = self._rr % len(self.sessions)
            self._rr += 1
            session = self.sessions[idx]
            for req in plan.requests:
                by_rid[req.rid].trace.begin("execute")
            t0 = time.perf_counter()
            with session.count_dispatches() as scope:
                outcome = self.batcher.execute(plan, session)
            _finish(session)
            wall = time.perf_counter() - t0
            self.slo.record_batch(len(plan), wall, scope.count, idx,
                                  energy_nj=scope.energy_nj)
            for req, result in zip(plan.requests, outcome.results):
                pend = by_rid[req.rid]
                pend.trace.end("execute")
                self.admission.release(req, pend.reservation)
                self.slo.record_completion(pend.trace)
                pend.deliver(result, None)
                completed += 1
        return completed

    @property
    def backlog(self) -> int:
        return len(self.queue)

    def snapshot(self) -> SloSnapshot:
        """Structured SLO snapshot (schema in ``docs/SERVING.md``)."""
        return self.slo.snapshot(self.cache.stats,
                                 tenants=self.admission.tenant_snapshot())

    def reset_slo(self) -> None:
        """Restart SLO windows at now (bench warm-up exclusion); the
        cache-hit window rebases to the cache's current counters."""
        self.slo.reset(self.cache.stats)

    # ------------------------------------------------------------- sync API
    def serve(self, requests: list[PudRequest]) -> list:
        """Admit all, tick until drained, return per-request results.

        Results align with ``requests``; a load-shed request's slot
        holds its :class:`DeadlineExceededError` instance (the
        ``asyncio.gather(return_exceptions=True)`` convention).
        Admission rejections raise immediately — backpressure is the
        caller's to handle.

        Honors ``cfg.tick_window_s`` exactly like the async loop: one
        coalescing wait after admission, before the batching ticks —
        giving co-submitted work from other threads the same window to
        land in the queue and coalesce (not one wait per tick, which
        would scale the wall time with the drain length).
        """
        slots: dict[int, object] = {}

        def deliver_to(i):
            def deliver(value, error=None):
                slots[i] = error if error is not None else value
            return deliver

        for i, req in enumerate(requests):
            self._enqueue(req, deliver_to(i))
        if self.cfg.tick_window_s:
            time.sleep(self.cfg.tick_window_s)
        while self.backlog:
            self.tick()
        return [slots[i] for i in range(len(requests))]

    # ------------------------------------------------------------ async API
    async def start(self) -> None:
        """Start the continuous-batching loop on the running event loop."""
        if self._running:
            return
        self._running = True
        self._wakeup = asyncio.Event()
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        """Drain the queue, then stop the loop."""
        if not self._running:
            return
        self._running = False
        self._wakeup.set()
        await self._task
        self._task = None

    async def submit(self, req: PudRequest):
        """Admit one request and await its result.

        Raises :class:`~repro_torch.serve.admission.AdmissionError` on
        backpressure and :class:`DeadlineExceededError` if the request
        is shed before execution.
        """
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def deliver(value, error=None):
            if fut.cancelled():
                return
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(value)

        self._enqueue(req, deliver)
        if self._wakeup is not None:
            self._wakeup.set()
        return await fut

    async def _loop(self) -> None:
        while True:
            await self._wakeup.wait()
            self._wakeup.clear()
            if self.cfg.tick_window_s:
                await asyncio.sleep(self.cfg.tick_window_s)
            while self.backlog:
                self.tick()
                await asyncio.sleep(0)  # let new submissions interleave
            if not self._running:
                return
