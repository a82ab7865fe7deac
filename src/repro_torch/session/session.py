"""DramSession: the one entry point for executing PUD work.

A session owns a resolved :class:`~repro_torch.backends.base.Backend` plus its
:class:`~repro_torch.backends.context.ExecutionContext`, and layers the three
things every consumer was hand-assembling on top of the registry:

* **typed construction** — :meth:`program` opens a
  :class:`~repro_torch.session.builder.SessionProgram` whose row handles come
  from a per-program allocator (build-time range/aliasing errors instead
  of kernel-side failures);
* **validated execution** — :meth:`run` / :meth:`run_fused` check any
  addressed Program (typed or hand-built) against the state image before
  a single kernel launches;
* **compile caching** — :meth:`run_fused` resolves the program's fused
  schedule through a content-hashed :class:`~repro_torch.session.cache.
  CompileCache`, so repeated programs (serve votes, sweep chunks, §8.1
  executors) skip re-scheduling and go straight to the backend's
  ``run_fused``.

A session also satisfies the backend surface by delegation (bulk ops,
``capabilities``, dispatch counters, the ``GateExecutor`` hooks
``gate_maj`` / ``gate_not``), so anything that accepted a ``Backend``
accepts a ``DramSession``.  :meth:`elementwise` runs a §8.1
microbenchmark with the session as the executor, so on a batch-native
backend the traced Program goes through :meth:`run_fused` — the compile
cache and certification.  Results are what the backend returns: ``int32``
tensors on the session's device (the card unless the context names
another), and a Python float from :meth:`success_rate`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch import obs
from repro_torch.backends import Backend, ExecutionContext, resolve_backend
from repro_torch.compile.schedule import Schedule
from repro_torch.pud.isa import Program
from repro_torch.session.builder import SessionProgram
from repro_torch.session.cache import CompileCache, program_key
from repro_torch.session.validate import check_program

#: Validation results cached per session: (program content key, n_rows).
_MAX_VALIDATED = 4096


class DramSession:
    """Typed facade over one backend + context + compile cache.

    ``backend`` is a registry name (the one-string choice) or an already
    -constructed :class:`Backend`; ``cache`` may be shared across
    sessions (schedules are pure program-content functions — the sweep
    runner shares one cache across its per-chunk sessions).
    """

    def __init__(self, backend: Union[str, Backend] = "cuda",
                 ctx: Optional[ExecutionContext] = None, *,
                 cache: Optional[CompileCache] = None,
                 name: Optional[str] = None):
        self.backend = resolve_backend(backend, ctx)
        self.cache = cache if cache is not None else CompileCache()
        self.name = name or f"session[{self.backend.name}]"
        self._validated: set[tuple[str, int]] = set()

    def __repr__(self) -> str:
        return (f"DramSession(backend={self.backend.name!r}, "
                f"cache={len(self.cache)} schedules)")

    @property
    def ctx(self) -> ExecutionContext:
        return self.backend.ctx

    # ------------------------------------------------- typed construction
    def program(self, rows: Optional[int] = None,
                name: Optional[str] = None) -> SessionProgram:
        """Open a typed program builder against a fresh row allocator."""
        return SessionProgram(self, rows=rows,
                              name=name or f"{self.name}/program")

    # ------------------------------------------------- program execution
    def _validate(self, program: Program, state, key: str) -> None:
        n_rows = int(state.shape[0])  # never reads a device tensor
        if (key, n_rows) in self._validated:
            return
        check_program(program, n_rows, where=self.name)
        if len(self._validated) >= _MAX_VALIDATED:
            self._validated.clear()
        self._validated.add((key, n_rows))

    def schedule_for(self, program: Program) -> Schedule:
        """The program's fused schedule, through the compile cache."""
        return self.cache.schedule_for(program)

    def run(self, program: Program, state) -> torch.Tensor:
        """Per-op interpretation, validated up front."""
        self._validate(program, state, program_key(program))
        return self.backend.run(program, state)

    def run_fused(self, program: Program, state, *,
                  mode: str = "fused") -> torch.Tensor:
        """Fused execution: validate, resolve the cached schedule, run.

        Bit-identical to :meth:`run` on every backend; batch-native
        backends execute one kernel dispatch per schedule group — or,
        with ``mode="megakernel"``, ONE dispatch for the whole program
        (backends that don't advertise the capability fall back to
        their exact path, see ``Backend.run_fused``).  A repeated
        program is a cache hit — no re-scheduling; in megakernel mode
        the lowered level tables cache under the same content key (with
        their own ``cache.lowering_stats`` window, so schedule-cache
        accounting is mode-independent).

        Unless ``ctx.certify`` is False, the resolved artifacts are
        also statically certified (race / liveness / equivalence, see
        :mod:`repro_torch.analyze`) through the cache's certificate store —
        one analysis per program content, raising
        :class:`~repro_torch.analyze.cert.CertificationError` if the compiled
        schedule or level tables ever diverge from program dataflow.

        The whole call is the span ``session.run_fused``
        (:mod:`repro_torch.obs`); the backend's own span is its child, and
        so is ``session.program_key``, the program's content hash (a
        lookup when the same Program object comes back unchanged, see
        :func:`~repro_torch.session.cache.program_key`).
        """
        with obs.span("session.run_fused"):
            with obs.span("session.program_key"):
                key = program_key(program)
            self._validate(program, state, key)
            sched = self.cache.schedule_for(program, key=key)
            lowering = None
            if mode == "megakernel" and self.capabilities().megakernel:
                lowering = self.cache.lowering_for(program, key=key,
                                                   sched=sched)
            if self.ctx.certify:
                # Static race/liveness/equivalence certification of the
                # exact artifacts about to execute; content-cached, so a
                # repeated program is a dictionary hit, not a re-analysis.
                self.cache.certificate_for(program, key=key, sched=sched,
                                           lowering=lowering)
            return self.backend.run_fused(program, state, sched=sched,
                                          mode=mode, lowering=lowering)

    # --------------------------------------------- §8.1 compiled arithmetic
    def elementwise(self, op: str, a, b, tier: Optional[int] = None,
                    n_act: Optional[int] = None):
        """Run a §8.1 microbenchmark with this session as the executor.

        Batch-native backends take the fused path through
        :meth:`run_fused` — i.e. through the compile cache."""
        from repro_torch.pud.arith import run_elementwise

        return run_elementwise(
            op, a, b, tier=tier or self.ctx.tier,
            n_act=n_act or self.ctx.n_act, executor=self)

    # ------------------------------------------------------ bulk delegation
    def capabilities(self):
        return self.backend.capabilities()

    def majx(self, planes: torch.Tensor, x: Optional[int] = None,
             n_act: Optional[int] = None) -> torch.Tensor:
        return self.backend.majx(planes, x=x, n_act=n_act)

    def majx_batch(self, planes: torch.Tensor) -> torch.Tensor:
        return self.backend.majx_batch(planes)

    def rowcopy(self, src: torch.Tensor, n_dst: int) -> torch.Tensor:
        return self.backend.rowcopy(src, n_dst)

    def mismatch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.backend.mismatch(a, b)

    def add_planes(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.backend.add_planes(a, b)

    def success_rate(self, got: torch.Tensor, want: torch.Tensor,
                     n_bits: Optional[int] = None) -> float:
        return self.backend.success_rate(got, want, n_bits=n_bits)

    # GateExecutor protocol (repro_torch.pud.arith) ---------------------
    def gate_maj(self, planes: Sequence[torch.Tensor], x: int,
                 n_act: int) -> torch.Tensor:
        return self.backend.gate_maj(planes, x, n_act)

    def gate_not(self, p: torch.Tensor) -> torch.Tensor:
        return self.backend.gate_not(p)

    # ------------------------------------------------- dispatch counters
    @property
    def dispatch_count(self) -> int:
        return self.backend.dispatch_count

    def reset_dispatches(self) -> None:
        self.backend.reset_dispatches()

    def count_dispatches(self):
        """Scoped kernel-launch counting (see Backend.count_dispatches)."""
        return self.backend.count_dispatches()
