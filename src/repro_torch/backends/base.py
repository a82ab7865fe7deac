"""The Backend protocol: one Program, interchangeable executors.

A backend executes PUD work at two granularities through one interface:

* **bulk entry points** — ``majx(planes, x, n_act)``,
  ``rowcopy(src, n_dst)``, ``mismatch(a, b)``, ``add_planes(a, b)`` on
  packed bit-planes (the layout of :mod:`repro_torch.core.bitplanes`:
  int32 tensors holding uint32 words);
* **programs** — ``run(program, state)`` interprets a
  :class:`repro_torch.pud.isa.Program` whose ops carry row addresses
  against a ``(rows, words)`` subarray image, and ``run_fused(program,
  state)`` executes the same program through the
  :mod:`repro_torch.compile` fusion scheduler (bit-identical results;
  batch-native backends collapse each dependency level into one kernel
  dispatch, or the whole schedule into one).

All knobs live in one shared
:class:`~repro_torch.backends.context.ExecutionContext`, including the
device every tensor lives on.  Implementations: ``oracle`` (plain
PyTorch reference) and ``cuda`` (hand-written CUDA kernels).
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backends.context import ExecutionContext
from repro_torch.core import bitplanes as bp
from repro_torch.pud.isa import Program


class DispatchScope:
    """A window over a backend's kernel-launch and energy counters.

    Produced by :meth:`Backend.count_dispatches`: ``.count`` is the
    launches issued since the scope opened and ``.energy_nj`` the
    modelled energy accrued (CostModel-priced: per-dispatch launch
    energy + device-memory traffic on the ``cuda`` backend), both frozen
    when the ``with`` block exits — so two workloads each read their own
    window of the monotonic counters.
    """

    def __init__(self, backend: "Backend"):
        self._backend = backend
        self._start = backend.dispatch_count
        self._stop: Optional[int] = None
        self._energy_start = backend.energy_nj_total
        self._energy_stop: Optional[float] = None

    @property
    def count(self) -> int:
        end = (self._backend.dispatch_count if self._stop is None
               else self._stop)
        return end - self._start

    @property
    def energy_nj(self) -> float:
        end = (self._backend.energy_nj_total if self._energy_stop is None
               else self._energy_stop)
        return end - self._energy_start


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend models / how it executes.

    Attributes:
        name: registry name the backend was instantiated under.
        description: one-line human summary of the execution model.
        stochastic: True when the paper-calibrated per-cell error
            surfaces are injected; exact digital results otherwise.
        device_model: True when ops execute through a behavioural
            APA/PRE/ACT command model rather than closed-form boolean
            semantics.
        accelerated: True when bulk ops launch hand-written GPU kernels.
        max_majx: widest MAJ arity this backend can execute (digital
            backends are unbounded in arity, reported as a large
            sentinel).
        n_act_levels: reachable simultaneous-activation counts
            (§4 Limitation 2: powers of two up to 32).
        native_batch: True when ``majx_batch`` is a single kernel
            launch rather than a python loop.
        megakernel: True when ``run_fused(mode="megakernel")`` executes
            a whole Schedule in ONE kernel launch via lowered level
            tables (:mod:`repro_torch.compile.megakernel`).  Backends
            without it still accept the mode and fall back to their
            exact per-op path.
    """

    name: str
    description: str
    stochastic: bool
    device_model: bool
    accelerated: bool
    max_majx: int
    n_act_levels: tuple[int, ...]
    native_batch: bool
    megakernel: bool = False


class Backend(abc.ABC):
    """Abstract executor for PUD operations (see module docstring)."""

    name: str = "?"

    def __init__(self, ctx: Optional[ExecutionContext] = None):
        self.ctx = ctx or ExecutionContext()
        self.device = torch.device(self.ctx.device)
        #: Kernel launches issued so far (bulk-op or program execution).
        #: Only accelerated backends increment it.
        self.dispatch_count = 0
        #: Modelled energy (nJ) accrued so far, priced by
        #: :data:`repro_torch.core.costmodel.COST`.  The ``oracle``
        #: reference accrues nothing (it models no hardware).
        self.energy_nj_total = 0.0

    def reset_dispatches(self) -> None:
        """Zero the counters (launches AND energy).

        Prefer :meth:`count_dispatches` for measurement.
        """
        self.dispatch_count = 0
        self.energy_nj_total = 0.0

    @contextlib.contextmanager
    def count_dispatches(self):
        """Scoped kernel-launch and energy counting.

        >>> with backend.count_dispatches() as scope:
        ...     backend.run_fused(program, state)
        >>> scope.count                # launches of that run alone
        """
        scope = DispatchScope(self)
        try:
            yield scope
        finally:
            scope._stop = self.dispatch_count
            scope._energy_stop = self.energy_nj_total

    # ------------------------------------------------------------- inputs
    def words(self, x) -> torch.Tensor:
        """Packed words as this backend computes on them.

        A ``uint32`` numpy array is copied to ``ctx.device``; a tensor
        must already be int32 on that device (a tensor elsewhere raises
        rather than silently running on another device).
        """
        if isinstance(x, np.ndarray):
            return bp.from_u32(x, self.device)
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError("packed words are uint32 numpy arrays or int32 "
                            f"tensors, got {type(x).__name__} "
                            f"{getattr(x, 'dtype', '')}")
        if x.device.type != self.device.type or (
                self.device.index is not None
                and x.device.index != self.device.index):
            raise ValueError(f"{self.name}: tensor on {x.device}, backend "
                             f"runs on {self.device}")
        return x

    def _index(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64),
                               device=self.device)

    # ------------------------------------------------------------ protocol
    @abc.abstractmethod
    def capabilities(self) -> Capabilities:
        """Self-description for capability-based dispatch."""

    @abc.abstractmethod
    def majx(self, planes, x: Optional[int] = None,
             n_act: Optional[int] = None) -> torch.Tensor:
        """MAJX over X packed operand planes.

        ``planes``: (X, words) or (X, R, C) words, X odd.  ``x`` defaults
        to ``planes.shape[0]``; ``n_act`` selects the replication ladder
        of §5 — it changes the *success rate*, never the logical result.
        Returns the majority plane, shape ``planes.shape[1:]``.
        """

    @abc.abstractmethod
    def rowcopy(self, src, n_dst: int) -> torch.Tensor:
        """Multi-RowCopy: replicate one row image to ``n_dst`` rows.

        ``src``: (words,) or (R, C).  Returns ``(n_dst, *src.shape)``.
        """

    @abc.abstractmethod
    def mismatch(self, a, b) -> torch.Tensor:
        """Total differing bits between two packed arrays (any shape)."""

    @abc.abstractmethod
    def add_planes(self, a, b) -> torch.Tensor:
        """Bit-serial ripple add over (NBITS, ...) packed planes."""

    # ------------------------------------------------- derived bulk helpers
    def majx_batch(self, planes) -> torch.Tensor:
        """Batched MAJX: (B, X, R, C) -> (B, R, C).

        Default is a python loop; backends with native batch dispatch
        (``cuda``) override with one kernel launch.
        """
        return torch.stack([self.majx(p) for p in self.words(planes)])

    def success_rate(self, got, want, n_bits: Optional[int] = None) -> float:
        """Fraction of matching bits — the paper's §3.1 metric."""
        got = self.words(got)
        total = int(n_bits) if n_bits else got.numel() * 32
        return 1.0 - int(self.mismatch(got, want)) / total

    # -------------------------------------------------- program execution
    def run(self, program: Program, state) -> torch.Tensor:
        """Execute an addressed Program against a (rows, words) image.

        Ops without destination addresses (cost-only streams) are
        skipped.  Returns the new image; the caller's tensor is never
        written (it is cloned once, and the clone updated in place).
        """
        state = self.words(state).clone()
        for op in program.ops:
            self._exec_op(op, state)
        return state

    def run_fused(self, program: Program, state, *, sched=None,
                  mode: str = "fused", lowering=None) -> torch.Tensor:
        """Execute an addressed Program through the fusion scheduler.

        Semantically identical to :meth:`run`.  The default falls back to
        per-op interpretation; backends with native batch dispatch
        (``cuda``) override this with level-batched kernel launches (see
        :mod:`repro_torch.compile.schedule`).

        ``mode`` selects the execution strategy: ``"fused"`` (level
        batching, the default) or ``"megakernel"`` (one dispatch for the
        whole schedule, see :mod:`repro_torch.compile.megakernel`).
        Every backend accepts every mode.  ``sched`` / ``lowering``
        optionally supply prebuilt compile artifacts; backends that
        interpret per-op ignore both.
        """
        if mode not in ("fused", "megakernel"):
            raise ValueError(f"unknown run_fused mode {mode!r}")
        return self.run(program, state)

    def _exec_op(self, op, state: torch.Tensor) -> None:
        """Apply one op to ``state`` in place."""
        if not op.dsts:
            return  # cost-only op: nothing addressable to do
        dsts = self._index(op.dsts)
        if op.kind == "MAJ":
            state[dsts] = self.majx(state[self._index(op.srcs)], x=op.x,
                                    n_act=op.n_act or None)
        elif op.kind == "NOT":
            state[dsts] = ~state[op.srcs[0]]
        elif op.kind == "COPY":
            state[dsts] = state[op.srcs[0]].clone()
        elif op.kind == "MRC":
            state[dsts] = self.rowcopy(state[op.srcs[0]], len(op.dsts))
        elif op.kind not in ("FRAC", "WR", "RD"):
            # FRAC: neutral rows don't vote, value-wise a no-op; WR/RD
            # are I/O accounting ops with no in-array effect.
            raise ValueError(f"unknown op kind {op.kind}")
