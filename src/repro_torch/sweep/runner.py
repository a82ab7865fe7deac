"""Sweep runner: execute planned chunks and stream records to the store.

Execution model:

* chunks already present in the :class:`~repro_torch.sweep.store.
  RecordStore` are skipped (resume); the remainder is optionally
  partitioned across workers with ``num_shards`` / ``shard_index``
  (disjoint by construction, see :func:`repro_torch.sweep.planner.shard`);
* chunks execute through per-regime :class:`~repro_torch.session.
  DramSession` instances on ``device`` (the card unless the caller names
  another); a chunk whose backend reports ``native_batch`` (``cuda``)
  lowers to an addressed single-level Program and executes through the
  session's compile-cached ``run_fused`` as one MAJX kernel launch
  (same-shaped chunks share one schedule); when a device mesh is
  supplied the stacked ``(B, X, R, C)`` batch instead goes through
  ``majx_batch`` placed with :func:`repro_torch.dist.sharding.
  sharding_for` over the mesh's data axis, so the B grid points of the
  chunk spread across the mesh's devices, one launch a shard;
* other backends execute point-by-point through the same bulk API
  (``mrc`` points on ``cuda`` are one fan-out kernel launch each);
* the ``analytic`` pseudo-backend evaluates the calibrated
  :class:`~repro_torch.core.errormodel.ErrorModel` surface — exact at
  every paper anchor, no data movement.

Every record carries both the *measured* success rate (bit-compare
against the ``oracle`` backend, the paper's §3.1 metric) and the
*expected* success from the calibrated surface at the same operating
point, so aggregation can diff behaviour against calibration.  The
compare runs on ``device`` through the session's ``mismatch`` (on
``cuda`` the mismatch kernel), in slices whose counts stay under 2**31.

:func:`run_sweep_ft` runs the same chunks on worker threads with
elastic membership and straggler re-dispatch (the ``repro_torch.ft``
consumer).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends import ExecutionContext, Timings
from repro_torch.core import bitplanes as bp
from repro_torch.core.errormodel import ErrorModel
from repro_torch.dist.sharding import sharding_for
from repro_torch.ft.elastic import ElasticMembership
from repro_torch.ft.failures import WorkerLost
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.session import CompileCache, DramSession
from repro_torch.sweep import planner
from repro_torch.sweep.spec import ANALYTIC, GridPoint, SweepSpec
from repro_torch.sweep.store import RecordStore, default_root

#: Words one mismatch count may cover: the count is an int32 sum that
#: wraps at 2**31 bits, so a larger comparison is counted in slices.
_COUNT_WORDS = (2**31 - 1) // 32

#: Word values for the fixed data patterns of §3.1 (pairs alternate
#: across operand planes; single-valued patterns fill the row).
_PATTERN_WORDS = {
    "0x00/0xFF": (0x00000000, 0xFFFFFFFF),
    "0xAA/0x55": (0xAAAAAAAA, 0x55555555),
    "0xCC/0x33": (0xCCCCCCCC, 0x33333333),
    "0x66/0x99": (0x66666666, 0x99999999),
    "0x00": (0x00000000, 0x00000000),
    "0xFF": (0xFFFFFFFF, 0xFFFFFFFF),
}


def _rng(spec: SweepSpec, p: GridPoint) -> np.random.Generator:
    """Data generator keyed by everything *except* backend/environment.

    Two backends measuring the same logical point see identical input
    data, which is what makes cross-backend record parity meaningful.
    """
    return np.random.default_rng(
        [p.seed, p.x, p.n_act, spec.rows, spec.words, 0x51338A])


def _planes(pattern: str, shape: tuple[int, ...],
            rng: np.random.Generator) -> np.ndarray:
    if pattern == "random":
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    a, b = _PATTERN_WORDS[pattern]
    out = np.empty(shape, dtype=np.uint32)
    # Alternate the pair along axis 0: across operand planes for MAJX
    # stacks, across words for a single MRC source row.
    out[0::2], out[1::2] = a, b
    return out


def _success(got: torch.Tensor, want: torch.Tensor,
             count: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
             ) -> tuple[float, int]:
    """Matching-bit fraction of ``got`` against ``want`` and the bits
    compared; ``count`` (a session's ``mismatch``) counts each slice."""
    got, want = got.reshape(-1), want.reshape(-1)
    n_bits = got.numel() * 32
    bad = sum(int(count(got[lo:lo + _COUNT_WORDS],
                        want[lo:lo + _COUNT_WORDS]))
              for lo in range(0, got.numel(), _COUNT_WORDS))
    return 1.0 - bad / n_bits, n_bits


def _context(spec: SweepSpec, p: GridPoint, device: str) -> ExecutionContext:
    timings = {"majx": dict(majx_t1=p.t1, majx_t2=p.t2),
               "mrc": dict(mrc_t1=p.t1, mrc_t2=p.t2),
               "simra": dict(simra_t1=p.t1, simra_t2=p.t2)}[p.op]
    return ExecutionContext(
        mfr=p.mfr, timings=Timings(**timings), temp_c=p.temp_c,
        vpp_v=p.vpp_v, pattern=p.pattern if p.op == "majx" else "random",
        ideal=spec.ideal, n_act=p.n_act, seed=p.seed, device=device)


def _expected(p: GridPoint) -> float:
    em = ErrorModel(p.mfr)
    if p.op == "majx":
        return em.majx_success(p.x, p.n_act, t1=p.t1, t2=p.t2,
                               pattern=p.pattern, temp_c=p.temp_c,
                               vpp_v=p.vpp_v)
    if p.op == "mrc":
        return em.mrc_success(p.n_dest, t1=p.t1, t2=p.t2, pattern=p.pattern,
                              temp_c=p.temp_c, vpp_v=p.vpp_v)
    return em.simra_success(p.n_act, t1=p.t1, t2=p.t2, temp_c=p.temp_c,
                            vpp_v=p.vpp_v)


@dataclasses.dataclass
class SweepResult:
    """What one :func:`run_sweep` invocation did and produced.

    ``executed_chunks`` ran in this invocation; ``cached_chunks`` were
    already complete in the store; ``pending_chunks`` belong to other
    shards or fell past ``max_chunks`` — they are *not* done yet.
    """

    spec: SweepSpec
    store_path: str
    n_points: int
    executed_chunks: int
    cached_chunks: int
    pending_chunks: int
    records: list[dict]

    def summary(self) -> str:
        pending = (f", {self.pending_chunks} pending"
                   if self.pending_chunks else "")
        return (f"sweep '{self.spec.name}' [{self.spec.spec_hash()}]: "
                f"{self.n_points} points, {self.executed_chunks} chunks "
                f"executed, {self.cached_chunks} cached{pending} -> "
                f"{len(self.records)} records at {self.store_path}")


class _Executor:
    """Measurement engine for one sweep.

    Sessions (and the backend instances under them) are cached *per
    chunk* (see :meth:`execute`): a chunk's records must be a pure
    function of (spec, chunk) so that kill/resume and worker sharding —
    which change *which process* executes a chunk, and in what order —
    can never change measured values.  A process-lifetime cache would
    leak mutable backend state (e.g. the ``sim`` backend's round-robin
    subarray cursor) across chunks and break that guarantee.  The
    *compile* cache is the exception and is deliberately process-wide:
    a schedule is a pure function of program content, so same-shaped
    chunks across the whole campaign share one fused schedule.
    """

    def __init__(self, spec: SweepSpec, mesh=None,
                 cache: Optional[CompileCache] = None,
                 device: str = "cuda"):
        self.spec = spec
        self.mesh = mesh
        self.device = device
        self._sessions: dict[tuple, DramSession] = {}
        # The compile cache is thread-safe and content-pure, so the
        # fault-tolerant runner shares ONE across its worker executors.
        self._compile_cache = cache if cache is not None else CompileCache()
        self._oracle = DramSession("oracle", ExecutionContext(device=device),
                                   name="sweep-oracle")

    def session(self, p: GridPoint) -> DramSession:
        ctx = _context(self.spec, p, self.device)
        key = (p.backend, ctx)
        if key not in self._sessions:
            self._sessions[key] = DramSession(
                p.backend, ctx, cache=self._compile_cache,
                name=f"sweep-{p.backend}")
        return self._sessions[key]

    # ---------------------------------------------------------- per point
    def _measure_majx(self, p: GridPoint) -> dict:
        shape = (p.x, self.spec.rows, self.spec.words)
        planes = _planes(p.pattern, shape, _rng(self.spec, p))
        want = self._oracle.majx(planes)
        sess = self.session(p)
        got = sess.majx(planes, x=p.x, n_act=p.n_act)
        success, n_bits = _success(got, want, sess.mismatch)
        return dict(p.record_base(), success=success,
                    expected=_expected(p), n_bits=n_bits)

    def _measure_mrc(self, p: GridPoint) -> dict:
        src = _planes(p.pattern, (self.spec.words,), _rng(self.spec, p))
        want = self._oracle.rowcopy(src, p.n_dest)
        sess = self.session(p)
        got = sess.rowcopy(src, p.n_dest)
        success, n_bits = _success(got, want, sess.mismatch)
        return dict(p.record_base(), success=success,
                    expected=_expected(p), n_bits=n_bits)

    def _analytic(self, p: GridPoint) -> dict:
        s = _expected(p)
        return dict(p.record_base(), success=s, expected=s, n_bits=0)

    # --------------------------------------------------------- per chunk
    def _majx_batched(self, chunk: planner.Chunk) -> list[dict]:
        """One fused kernel dispatch for the whole chunk (cuda).

        The chunk lowers to an addressed single-level Program
        (:func:`repro_torch.sweep.planner.fused_majx_program`) executed
        via the session's compile-cached ``run_fused`` — the same fusion
        engine the §8.1 programs use, and every same-shaped chunk after
        the first is a schedule-cache hit.  The stacked batch is uploaded
        once; the state image (operands, then zeroed output rows) is
        assembled on the device, and the oracle reads the same upload.
        Under a device mesh the stacked batch instead goes through
        ``majx_batch``, one launch for each distinct shard of the B grid
        points over the mesh's data axis, each on its device.
        Its steps are :mod:`repro_torch.obs` spans (``sweep.draws``,
        ``sweep.upload``, ``sweep.fused_run``, ``sweep.oracle``,
        ``sweep.counts``), which a profiled chunk's trace splits its
        time by.
        """
        pts = chunk.points
        rows, words = self.spec.rows, self.spec.words
        with obs.span("sweep.draws"):
            batch = np.stack([
                _planes(p.pattern, (p.x, rows, words),
                        _rng(self.spec, p)) for p in pts])  # (B, X, R, C)
        sess = self.session(pts[0])
        with obs.span("sweep.upload"):
            data = bp.from_u32(batch, self.device)
        with obs.span("sweep.fused_run"):
            if self.mesh is not None:
                placed = sharding_for(data.shape, ("batch", None, None, None),
                                      self.mesh).shards(data)
                got = torch.cat([sess.majx_batch(shard).to(data.device)
                                 for _, shard in placed])    # (B, R, C)
            else:
                prog, out_base = planner.fused_majx_program(pts, rows)
                state = torch.cat([data.reshape(-1, words),
                                   data.new_zeros((len(pts) * rows, words))])
                final = sess.run_fused(prog, state)
                got = final[out_base:].reshape(len(pts), rows, words)
        # Same reference source as the per-point path: the oracle backend.
        with obs.span("sweep.oracle"):
            want = self._oracle.majx_batch(data)
        out = []
        with obs.span("sweep.counts"):
            for i, p in enumerate(pts):
                success, n_bits = _success(got[i], want[i], sess.mismatch)
                out.append(dict(p.record_base(), success=success,
                                expected=_expected(p), n_bits=n_bits))
        return out

    def execute(self, chunk: planner.Chunk) -> list[dict]:
        # Fresh sessions (and backends) per chunk: records depend only
        # on (spec, chunk), never on which chunks this process ran
        # before.  The shared compile cache survives — schedules are
        # content-pure.
        self._sessions.clear()
        if chunk.backend == ANALYTIC or self.spec.op == "simra":
            return [self._analytic(p) for p in chunk.points]
        if self.spec.op == "majx":
            caps = self.session(chunk.points[0]).capabilities()
            # The fused batch path runs the whole chunk under one
            # ExecutionContext, so it is only valid for backends whose
            # results are regime-insensitive (digital: no error
            # injection, no device model).  Regime-sensitive executors
            # fall back to per-point contexts — correct, just unfused.
            if (caps.native_batch and len(chunk.points) > 1
                    and not caps.stochastic and not caps.device_model
                    and len({p.x for p in chunk.points}) == 1):
                return self._majx_batched(chunk)
            return [self._measure_majx(p) for p in chunk.points]
        return [self._measure_mrc(p) for p in chunk.points]


def run_sweep(spec: SweepSpec, root: Optional[str] = None, *,
              num_shards: int = 1, shard_index: int = 0,
              max_chunks: Optional[int] = None, mesh=None,
              store: Optional[RecordStore] = None,
              progress: bool = False, device: str = "cuda") -> SweepResult:
    """Execute (the missing part of) a sweep and return all records.

    Resume semantics: chunks whose files already exist in the store are
    never re-executed; a run over a fully-populated store performs zero
    executions.  ``max_chunks`` bounds this invocation's work (used by
    tests to simulate a mid-campaign kill); ``num_shards``/``shard_index``
    restrict this worker to its deterministic share of the plan.  Pass
    ``store=`` to supply a pre-bound :class:`RecordStore` (e.g. one on a
    non-default :class:`~repro_torch.sweep.store.RecordStoreBackend`);
    ``root`` is ignored in that case.  ``device`` is where every
    session's tensors live and its kernels run; under ``mesh`` a
    ``cuda`` chunk's batch is split over the mesh's devices.
    """
    if store is None:
        store = RecordStore(default_root(root), spec)
    chunks = planner.plan(spec)
    done = store.completed()
    todo = [c for c in planner.shard(chunks, num_shards, shard_index)
            if c.key not in done]
    if max_chunks is not None:
        todo = todo[:max_chunks]

    ex = _Executor(spec, mesh=mesh, device=device)
    for i, chunk in enumerate(todo):
        records = ex.execute(chunk)
        store.put(chunk, records)
        if progress:
            print(f"[sweep {spec.name}] {chunk.key} "
                  f"({i + 1}/{len(todo)}, {len(records)} points)",
                  flush=True)

    cached = sum(1 for c in chunks if c.key in done)
    return SweepResult(
        spec=spec, store_path=store.path, n_points=spec.n_points(),
        executed_chunks=len(todo), cached_chunks=cached,
        pending_chunks=len(chunks) - cached - len(todo),
        records=store.records())


def records_for(spec: SweepSpec, root: Optional[str] = None,
                **run_kw) -> list[dict]:
    """Records of a sweep, running whatever the store is missing."""
    return run_sweep(spec, root, **run_kw).records


# --------------------------------------------------------------------------
# fault-tolerant multi-worker runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FtSweepResult:
    """What one :func:`run_sweep_ft` invocation did and produced.

    ``executed_chunks`` counts chunk executions (a re-dispatched chunk
    that both the straggler and the rescuer finish counts twice — the
    store keeps one copy, last ``os.replace`` wins with identical
    content); ``re_dispatched`` counts chunks stolen from flagged
    stragglers; ``lost_workers`` are workers that left the elastic
    membership mid-run.
    """

    spec: SweepSpec
    store_path: str
    n_points: int
    executed_chunks: int
    cached_chunks: int
    re_dispatched: int
    lost_workers: list[int]
    worker_chunks: dict[int, int]
    fleet_slowdown: float
    records: list[dict]

    def summary(self) -> str:
        lost = (f", lost workers {self.lost_workers}"
                if self.lost_workers else "")
        redisp = (f", {self.re_dispatched} re-dispatched"
                  if self.re_dispatched else "")
        return (f"ft-sweep '{self.spec.name}' [{self.spec.spec_hash()}]: "
                f"{self.n_points} points, {self.executed_chunks} chunks "
                f"executed across {len(self.worker_chunks)} workers, "
                f"{self.cached_chunks} cached{redisp}{lost} -> "
                f"{len(self.records)} records at {self.store_path}")


class _FtState:
    """Lock-guarded shared state of one fault-tolerant run."""

    def __init__(self, todo: list[planner.Chunk], n_workers: int,
                 threshold: float):
        self.lock = threading.Lock()
        self.todo = todo
        self.todo_keys = {c.key for c in todo}
        self.done: set[str] = set()
        self.claimed: dict[str, int] = {}
        self.inflight: dict[int, tuple[planner.Chunk, float]] = {}
        self.stolen: collections.deque[planner.Chunk] = collections.deque()
        self.redispatched: set[str] = set()
        self.executed_by: dict[int, int] = {w: 0 for w in range(n_workers)}
        self.membership = ElasticMembership(n_workers)
        self.detector = StragglerDetector(n_workers, threshold=threshold)
        self.error: Optional[BaseException] = None

    # Callers hold self.lock for every method below.
    def pick(self, worker: int) -> Optional[planner.Chunk]:
        """Next chunk for ``worker``: stolen work first, then its own
        share of the elastic partition over unclaimed pending chunks."""
        while self.stolen:
            chunk = self.stolen.popleft()
            if chunk.key not in self.done:
                self.claimed[chunk.key] = worker
                self.inflight[worker] = (chunk, time.monotonic())
                return chunk
        pending = [c for c in self.todo if c.key not in self.done
                   and c.key not in self.claimed]
        mine = self.membership.share(pending, worker)
        if not mine:
            return None
        chunk = mine[0]
        self.claimed[chunk.key] = worker
        self.inflight[worker] = (chunk, time.monotonic())
        return chunk

    def all_done(self) -> bool:
        return self.done >= self.todo_keys

    def flagged_stragglers(self, now: float) -> set[int]:
        """Workers the detector flags, counting in-flight elapsed time
        as a provisional sample — so a worker stuck on its *first*
        chunk (no completed sample yet) is still caught."""
        trial = StragglerDetector(
            self.detector.n_workers, alpha=self.detector.alpha,
            threshold=self.detector.threshold, ema=self.detector.ema.copy(),
            n_samples=self.detector.n_samples.copy())
        for wid, (_, t0) in self.inflight.items():
            trial.record(wid, now - t0)
        return set(trial.stragglers())


def _ft_worker(wid: int, spec: SweepSpec, store: RecordStore, st: _FtState,
               stop: threading.Event, cache: CompileCache, mesh,
               worker_hook, poll_s: float, progress: bool,
               device: str) -> None:
    ex = _Executor(spec, mesh=mesh, cache=cache, device=device)
    while not stop.is_set():
        with st.lock:
            if st.all_done():
                return
            chunk = st.pick(wid)
        if chunk is None:
            time.sleep(poll_s)
            continue
        t0 = time.monotonic()
        try:
            if worker_hook is not None:
                worker_hook(wid, chunk)
            records = ex.execute(chunk)
        except WorkerLost:
            with st.lock:
                st.membership.drop(wid)
                st.inflight.pop(wid, None)
                # Release the claim: the survivors' repartition covers it.
                if st.claimed.get(chunk.key) == wid:
                    del st.claimed[chunk.key]
            return
        except BaseException as e:  # surfaced by the monitor
            with st.lock:
                st.error = st.error or e
                st.membership.drop(wid)
                st.inflight.pop(wid, None)
                if st.claimed.get(chunk.key) == wid:
                    del st.claimed[chunk.key]
            return
        if stop.is_set():
            return  # run already complete; drop redundant duplicate work
        store.put(chunk, records)
        with st.lock:
            st.done.add(chunk.key)
            st.inflight.pop(wid, None)
            st.executed_by[wid] += 1
            st.detector.record(wid, max(time.monotonic() - t0, 1e-9))
        if progress:
            print(f"[ft-sweep {spec.name}] worker {wid} {chunk.key} "
                  f"({len(records)} points)", flush=True)


def run_sweep_ft(spec: SweepSpec, root: Optional[str] = None, *,
                 n_workers: int = 2,
                 worker_hook: Optional[Callable[[int, planner.Chunk],
                                               None]] = None,
                 straggler_threshold: float = 1.5,
                 straggler_timeout_s: float = 5.0,
                 poll_s: float = 0.02, mesh=None,
                 store: Optional[RecordStore] = None,
                 progress: bool = False,
                 device: str = "cuda") -> FtSweepResult:
    """Multi-worker :func:`run_sweep` with elastic membership and
    straggler re-dispatch (the ``repro_torch.ft`` consumer).

    ``n_workers`` threads share one :class:`RecordStore` and one
    thread-safe compile cache; pending chunks are partitioned
    round-robin over the *live* worker roster
    (:class:`repro_torch.ft.elastic.ElasticMembership`) and the partition
    replans whenever membership changes.  Per-chunk wall times feed a
    :class:`repro_torch.ft.straggler.StragglerDetector`; a chunk in flight on
    a flagged straggler for longer than ``straggler_timeout_s`` is
    re-dispatched (once) to a healthy worker.  Both may finish — chunk
    files are atomic and records are a pure function of (spec, chunk),
    so the duplicate ``os.replace`` writes identical content and
    last-write wins harmlessly.

    ``worker_hook(worker_id, chunk)`` runs before every execution
    attempt; tests inject failures by raising
    :class:`repro_torch.ft.failures.WorkerLost` (elastic drop) or by
    sleeping (straggler).  Raises ``RuntimeError`` if every worker is
    lost with chunks still pending.  The workers' sessions run on
    ``device`` and share its default stream; a straggler may still be
    running its duplicate when this returns (its result is dropped).
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if store is None:
        store = RecordStore(default_root(root), spec)
    chunks = planner.plan(spec)
    done0 = store.completed()
    todo = [c for c in chunks if c.key not in done0]
    cached = sum(1 for c in chunks if c.key in done0)
    st = _FtState(todo, n_workers, straggler_threshold)
    stop = threading.Event()

    if todo:
        cache = CompileCache()
        threads = [
            threading.Thread(
                target=_ft_worker, name=f"sweep-ft-{w}",
                args=(w, spec, store, st, stop, cache, mesh, worker_hook,
                      poll_s, progress, device),
                daemon=True)
            for w in range(n_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                with st.lock:
                    if st.error is not None:
                        raise RuntimeError(
                            "sweep worker failed") from st.error
                    if st.all_done():
                        break
                    if not st.membership.live:
                        raise RuntimeError(
                            f"all {n_workers} workers lost with "
                            f"{len(st.todo_keys - st.done)} chunks pending")
                    now = time.monotonic()
                    flagged = st.flagged_stragglers(now)
                    for wid, (chunk, t0) in list(st.inflight.items()):
                        if (wid in flagged
                                and now - t0 > straggler_timeout_s
                                and chunk.key not in st.redispatched
                                and chunk.key not in st.done
                                and len(st.membership.live) > 1):
                            st.stolen.append(chunk)
                            st.redispatched.add(chunk.key)
                            if progress:
                                print(f"[ft-sweep {spec.name}] re-dispatch "
                                      f"{chunk.key} from straggler {wid}",
                                      flush=True)
                time.sleep(poll_s)
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=poll_s * 5)  # stragglers may still be sleeping

    with st.lock:
        return FtSweepResult(
            spec=spec, store_path=store.path, n_points=spec.n_points(),
            executed_chunks=sum(st.executed_by.values()),
            cached_chunks=cached, re_dispatched=len(st.redispatched),
            lost_workers=list(st.membership.dropped),
            worker_chunks=dict(st.executed_by),
            fleet_slowdown=st.detector.fleet_slowdown(),
            records=store.records())
