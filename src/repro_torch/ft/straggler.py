"""Straggler detection & mitigation.

At pod scale the dominant mitigation is *not* per-op work stealing (SPMD
steps are lockstep) but (a) detecting persistently slow workers and
(b) re-meshing without them (the reference's ``ft/elastic.py``, which
the port takes with the sweep), plus (c) bounded-delay step skipping for
transient hiccups.  The detector keeps a per-worker EMA
of step durations and flags workers whose EMA exceeds the fleet median by
``threshold`` x; the trainer consults it every ``check_every`` steps, the
serve layer's SLO monitor (:mod:`repro_torch.serve.slo`) reuses it with
one "worker" per pooled ``DramSession`` to flag persistently slow
sessions.  The module is a copy of the reference's (numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    """Per-worker EMA step-time tracker (see module docstring).

    ``ema`` may be seeded with a prior ``(n_workers,)`` vector (resuming
    a detector across re-meshes); a seeded detector is treated as warm —
    every worker counts as having one prior sample unless ``n_samples``
    is seeded alongside it.  Cold workers ("no sample yet") are tracked
    by the explicit ``n_samples`` counter, *never* by an ``ema == 0``
    sentinel: a genuine 0.0-duration sample (or an EMA that decays to
    0) still marks its worker as measured, so it participates in
    :meth:`stragglers` / :meth:`fleet_slowdown` like any other.  Both
    fields are normalized and shape-checked in ``__post_init__`` — after
    construction they are always ``(n_workers,)`` arrays, never ``None``.
    """

    n_workers: int
    alpha: float = 0.2
    threshold: float = 1.5
    ema: Optional[np.ndarray] = dataclasses.field(default=None)
    n_samples: Optional[np.ndarray] = dataclasses.field(default=None)

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        seeded = self.ema is not None
        if not seeded:
            self.ema = np.zeros(self.n_workers)
        else:
            self.ema = np.asarray(self.ema, dtype=float)
            if self.ema.shape != (self.n_workers,):
                raise ValueError(
                    f"seeded ema shape {self.ema.shape} != "
                    f"({self.n_workers},)")
        if self.n_samples is None:
            self.n_samples = (np.ones(self.n_workers, dtype=np.int64)
                              if seeded else
                              np.zeros(self.n_workers, dtype=np.int64))
        else:
            self.n_samples = np.asarray(self.n_samples, dtype=np.int64)
            if self.n_samples.shape != (self.n_workers,):
                raise ValueError(
                    f"seeded n_samples shape {self.n_samples.shape} != "
                    f"({self.n_workers},)")

    def record(self, worker: int, step_time_s: float) -> None:
        if self.n_samples[worker] == 0:
            self.ema[worker] = step_time_s
        else:
            self.ema[worker] = ((1 - self.alpha) * self.ema[worker]
                                + self.alpha * step_time_s)
        self.n_samples[worker] += 1

    def _measured(self) -> np.ndarray:
        return self.n_samples > 0

    def stragglers(self) -> list[int]:
        measured = self._measured()
        active = self.ema[measured]
        if active.size < max(2, self.n_workers // 2):
            return []
        median = float(np.median(active))
        return [int(i) for i in range(self.n_workers)
                if measured[i] and self.ema[i] > self.threshold * median]

    def fleet_slowdown(self) -> float:
        """Step-time inflation caused by the slowest worker (lockstep SPMD)."""
        active = self.ema[self._measured()]
        if active.size == 0:
            return 1.0
        median = float(np.median(active))
        if median == 0.0:
            # An all-instant (or decayed-to-zero) fleet has no meaningful
            # relative slowdown; any nonzero worker above it is infinite.
            return float("inf") if float(active.max()) > 0.0 else 1.0
        return float(active.max() / median)
