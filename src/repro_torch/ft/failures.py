"""Failure injection & detection for the checkpoint-restart trainer.

On a real cluster, failures surface as missing heartbeats / NCCL-ICI
timeouts; here they are injected deterministically so the restart path is
exercised by tests and examples.  The trainer treats any
:class:`SimulatedFailure` as a node loss: it re-initializes from the last
committed checkpoint and replays the data stream from the recorded step
(the pipeline is step-keyed, so replay is exact).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class SimulatedFailure(RuntimeError):
    """A injected node/process failure."""


class WorkerLost(SimulatedFailure):
    """An injected sweep-worker loss.

    Raised from a worker hook to simulate a process dying mid-chunk;
    the fault-tolerant sweep runner
    (:func:`repro_torch.sweep.runner.run_sweep_ft`) treats it as permanent
    membership loss: the worker leaves the elastic partition and its
    in-flight chunk is released for the survivors.
    """


@dataclasses.dataclass
class FailurePlan:
    """Fail at specific steps (once each)."""

    at_steps: tuple[int, ...] = ()
    kind: str = "node_loss"
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"{self.kind} at step {step}")


@dataclasses.dataclass
class HeartbeatMonitor:
    """Deadline-based failure detector (the real-cluster shape of check())."""

    deadline_s: float = 300.0
    last_beat: Optional[float] = None

    def beat(self, now: float) -> None:
        self.last_beat = now

    def healthy(self, now: float) -> bool:
        return self.last_beat is None or (now - self.last_beat) < self.deadline_s
