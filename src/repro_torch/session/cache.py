"""Content-hashed compile cache: schedule a Program once, run it forever.

Fused execution pays a host-side compile step per program —
:func:`repro_torch.compile.schedule.build_schedule` levels the op stream and
groups each level's dispatches.  The workloads that matter repeat the
*same* program many times (serve ``heal_params`` votes every epoch,
sweep chunks share one chunk shape, ``pud.arith`` executors re-run a
traced adder per batch), so :class:`CompileCache` memoizes schedules by
program *content*: a SHA-256 over every op's semantic fields — kind,
arity, activation count, row addresses — deliberately excluding the
provenance ``tag``, which executors never read.  Two sweep chunks whose
ops differ only in point-index tags therefore share one schedule.

A :class:`~repro_torch.compile.schedule.Schedule` is a pure function of that
content (frozen dataclasses, no backend state), so one cache can be
shared across sessions — the sweep runner shares a process-wide cache
across its per-chunk sessions, and the serve layer's session pool
shares one across concurrent request batches.  Lookups are serialized
by a lock (build included), so N concurrent submissions of one program
shape are exactly 1 miss + N-1 hits — never N racing builds.
``stats`` records hits/misses; the bench harnesses report the hit rate
in ``BENCH_fused.json`` / ``BENCH_serve.json``.

Megakernel artifacts cache under the *same* content key: a
:class:`~repro_torch.compile.megakernel.MegaLowering` is a pure function of
the schedule, which is a pure function of program content, so
:meth:`CompileCache.lowering_for` keys its table store by
``program_key`` too.  Lowerings keep separate ``lowering_stats`` —
schedule hit/miss counts are load-bearing in the serve tests and must
not move when a consumer opts into megakernel mode.

Each hash is taken once per artifact that cannot change: a Program
remembers its key beside the op objects it was computed from, and the
cache remembers the digest of each lowering it built, whose tables it
made read-only.  A Program run again unchanged (a compiled op, an
executor's traced Program) and its cached lowering cost a lookup a call,
not a hash; a new or changed Program is hashed as before.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import weakref
from typing import Optional, TYPE_CHECKING

import numpy as np

from repro_torch import obs
from repro_torch.compile.schedule import Schedule, build_schedule
from repro_torch.pud.isa import Program

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for hints only
    from repro_torch.analyze.cert import Certificate
    from repro_torch.compile.megakernel import MegaLowering


def program_key(program: Program) -> str:
    """Content hash of a Program's semantic fields (tags excluded).

    The key is kept on the Program beside a snapshot of its op objects,
    ``tuple(program.ops)``.  A later call returns it only when the
    Program's ops equal that snapshot: tuple comparison tries identity
    first and ``PUDOp`` is frozen, so an appended, removed or replaced
    op, or a new ``ops`` list, is hashed afresh (an op replaced by an
    equal one keeps its key).  Counters ``cache.key_hits`` /
    ``cache.key_misses`` (:mod:`repro_torch.obs`) count the two cases.
    """
    ops = tuple(program.ops)
    memo = getattr(program, "_key_memo", None)
    if memo is not None and memo[0] == ops:
        obs.count("cache.key_hits")
        return memo[1]
    obs.count("cache.key_misses")
    h = hashlib.sha256()
    for op in ops:
        h.update(
            f"{op.kind}|{op.x}|{op.n_act}|{op.srcs}|{op.dsts}\n".encode())
    key = h.hexdigest()
    program._key_memo = (ops, key)
    return key


def _read_only(table: np.ndarray) -> np.ndarray:
    """A copy of ``table`` over an immutable buffer: numpy refuses to
    write it or to make it writable again."""
    return np.frombuffer(np.ascontiguousarray(table).tobytes(),
                         dtype=table.dtype).reshape(table.shape)


@dataclasses.dataclass
class CacheStats:
    """Hit/miss counters, comparable across snapshots for windowing."""

    hits: int = 0
    misses: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)

    def delta(self, earlier: "CacheStats") -> "CacheStats":
        """Stats accumulated since an ``earlier`` :meth:`snapshot`."""
        return CacheStats(hits=self.hits - earlier.hits,
                          misses=self.misses - earlier.misses)


class CompileCache:
    """LRU cache: ``program_key`` -> built :class:`Schedule`.

    A second LRU store under the same keys holds megakernel
    :class:`~repro_torch.compile.megakernel.MegaLowering` tables
    (:meth:`lowering_for`), with its own ``lowering_stats`` window; a
    third holds analysis :class:`~repro_torch.analyze.cert.Certificate`
    records (:meth:`certificate_for`, ``certificate_stats``) so a
    repeated program certifies once and is a pure lookup afterwards.
    """

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self.stats = CacheStats()
        self.lowering_stats = CacheStats()
        self.certificate_stats = CacheStats()
        self._entries: collections.OrderedDict[str, Schedule] = \
            collections.OrderedDict()
        self._lowerings: "collections.OrderedDict[str, MegaLowering]" = \
            collections.OrderedDict()
        self._certificates: "collections.OrderedDict[str, Certificate]" = \
            collections.OrderedDict()
        #: Lowerings this cache built (read-only tables) -> digest.
        self._digests: "weakref.WeakKeyDictionary[MegaLowering, str]" = \
            weakref.WeakKeyDictionary()
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    def schedule_for(self, program: Program,
                     key: Optional[str] = None) -> Schedule:
        """The program's schedule — cached, or built and admitted.

        Pass a precomputed ``key`` (from :func:`program_key`) to skip
        re-hashing when the caller already derived it.  Thread-safe:
        the first caller for a key builds under the lock, concurrent
        callers for the same key wait and hit.
        """
        return self._cached(self._entries, self.stats,
                            key or program_key(program),
                            lambda: build_schedule(program))

    def lowering_for(self, program: Program, key: Optional[str] = None,
                     sched: Optional[Schedule] = None) -> "MegaLowering":
        """The program's megakernel level tables — cached by content.

        Resolves the schedule through :meth:`schedule_for` first (the
        lock is re-entrant, so this is one serialized pass) unless the
        caller hands one in.  Hits/misses land on ``lowering_stats``,
        never on ``stats`` — schedule-cache accounting is unchanged by
        megakernel execution.

        The tables of a lowering built here are read-only copies of
        :func:`~repro_torch.compile.megakernel.lower_schedule`'s (one
        copy, at the miss), over buffers that cannot be made writable
        again; the cache digests them once, so a certificate check of
        this lowering is a lookup (:meth:`certificate_for`).
        """
        from repro_torch.compile.megakernel import lower_schedule

        key = key or program_key(program)

        def build():
            low = lower_schedule(
                sched if sched is not None
                else self.schedule_for(program, key=key))
            low = dataclasses.replace(low, src=_read_only(low.src),
                                      dst=_read_only(low.dst),
                                      inv=_read_only(low.inv))
            self._digests[low] = low.digest()
            return low
        return self._cached(self._lowerings, self.lowering_stats, key,
                            build)

    def certificate_for(self, program: Program, key: Optional[str] = None,
                        sched: Optional[Schedule] = None,
                        lowering: "Optional[MegaLowering]" = None
                        ) -> "Certificate":
        """The program's analysis :class:`~repro_torch.analyze.cert.
        Certificate`.

        Cached under the same content key as schedules, with a third
        stats window (``certificate_stats``): a *hit* means the artifact
        was admitted analyzed and zero re-analysis happened — the
        property the CI gate asserts.  A cached fused-only certificate
        is *upgraded* (one extra miss) the first time the caller also
        hands in a megakernel ``lowering``; a lowering-covering
        certificate satisfies fused-only lookups.  Raises
        :class:`~repro_torch.analyze.cert.CertificationError` on any error
        finding — a program that fails certification is never admitted.
        A hit's check of the lowering compares its digest with the
        certificate's, in the span ``cache.lowering_digest``
        (:mod:`repro_torch.obs`): a lowering this cache built reads the
        digest taken when it was built (counter ``cache.digest_hits``);
        any other lowering, such as one a caller built and may have
        changed, is digested again on every call
        (``cache.digest_misses``).
        """
        from repro_torch.analyze.cert import certify

        key = key or program_key(program)

        def covers(cert) -> bool:
            if lowering is None:
                return True
            with obs.span("cache.lowering_digest"):
                return cert.lowering_digest == self._digest(lowering)

        def build():
            return certify(program, sched=sched if sched is not None
                           else self.schedule_for(program, key=key),
                           lowering=lowering, key=key,
                           where=f"program {key[:12]}")
        return self._cached(self._certificates, self.certificate_stats,
                            key, build, covers)

    def _cached(self, store: collections.OrderedDict, stats: CacheStats,
                key: str, build, hit=lambda entry: True):
        """The LRU block of the three stores, under the lock: ``store``'s
        entry for ``key`` where ``hit`` accepts it (moved to the recent
        end; a hit on ``stats``), else ``build()`` admitted under ``key``
        (a miss; the oldest entries past ``maxsize`` are evicted)."""
        with self._lock:
            entry = store.get(key)
            if entry is not None and hit(entry):
                store.move_to_end(key)
                stats.hits += 1
                return entry
            stats.misses += 1
            entry = store[key] = build()
            while len(store) > self.maxsize:
                store.popitem(last=False)
            return entry

    def _digest(self, lowering: "MegaLowering") -> str:
        """``lowering.digest()``, remembered for lowerings built here."""
        digest = self._digests.get(lowering)
        if digest is not None:
            obs.count("cache.digest_hits")
            return digest
        obs.count("cache.digest_misses")
        return lowering.digest()
