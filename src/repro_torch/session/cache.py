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
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Optional, TYPE_CHECKING

from repro_torch.compile.schedule import Schedule, build_schedule
from repro_torch.pud.isa import Program

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for hints only
    from repro_torch.analyze.cert import Certificate
    from repro_torch.compile.megakernel import MegaLowering


def program_key(program: Program) -> str:
    """Content hash of a Program's semantic fields (tags excluded)."""
    h = hashlib.sha256()
    for op in program.ops:
        h.update(
            f"{op.kind}|{op.x}|{op.n_act}|{op.srcs}|{op.dsts}\n".encode())
    return h.hexdigest()


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
        key = key or program_key(program)
        with self._lock:
            sched = self._entries.get(key)
            if sched is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return sched
            self.stats.misses += 1
            sched = build_schedule(program)
            self._entries[key] = sched
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return sched

    def lowering_for(self, program: Program, key: Optional[str] = None,
                     sched: Optional[Schedule] = None) -> "MegaLowering":
        """The program's megakernel level tables — cached by content.

        Resolves the schedule through :meth:`schedule_for` first (the
        lock is re-entrant, so this is one serialized pass) unless the
        caller hands one in.  Hits/misses land on ``lowering_stats``,
        never on ``stats`` — schedule-cache accounting is unchanged by
        megakernel execution.
        """
        from repro_torch.compile.megakernel import lower_schedule

        key = key or program_key(program)
        with self._lock:
            low = self._lowerings.get(key)
            if low is not None:
                self._lowerings.move_to_end(key)
                self.lowering_stats.hits += 1
                return low
            self.lowering_stats.misses += 1
            if sched is None:
                sched = self.schedule_for(program, key=key)
            low = lower_schedule(sched)
            self._lowerings[key] = low
            while len(self._lowerings) > self.maxsize:
                self._lowerings.popitem(last=False)
            return low

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
        """
        from repro_torch.analyze.cert import certify

        key = key or program_key(program)
        with self._lock:
            cert = self._certificates.get(key)
            if cert is not None and (lowering is None
                                     or cert.lowering_digest
                                     == lowering.digest()):
                self._certificates.move_to_end(key)
                self.certificate_stats.hits += 1
                return cert
            self.certificate_stats.misses += 1
            if sched is None:
                sched = self.schedule_for(program, key=key)
            cert = certify(program, sched=sched, lowering=lowering,
                           key=key, where=f"program {key[:12]}")
            self._certificates[key] = cert
            while len(self._certificates) > self.maxsize:
                self._certificates.popitem(last=False)
            return cert
