"""Trainer: the production loop — checkpoint/restart, failure handling,
straggler monitoring, TMR-protected state, deterministic data replay.

It runs on the card (``device="cuda"``, the default) unless asked for the
host, and raises where no card is present.  The step runs eagerly; the
trainer holds one state at a time (the step's input and its output
during a step), so a state at full width needs twice its bytes, not
three times.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import tmr_store
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft.failures import FailurePlan, SimulatedFailure
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    tmr_replicas: int = 0          # 0 = plain store; 3/5 = voted store
    log_every: int = 10
    max_restarts: int = 3


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 loader: SyntheticLM, trainer_cfg: TrainerConfig = None,
                 failure_plan: Optional[FailurePlan] = None,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (torch.cuda."
                               "is_available() is false); pass "
                               "device='cpu' to train on the host")
        self.cfg = cfg
        self.tc = tc
        self.loader = loader
        self.tcfg = trainer_cfg or TrainerConfig()
        self.failures = failure_plan or FailurePlan()
        self.log = log_fn
        self.stragglers = StragglerDetector(
            n_workers=(torch.cuda.device_count()
                       if self.device.type == "cuda" else 1))
        self.step_fn = make_train_step(cfg, tc)
        self.history: list[dict] = []
        self._state: Optional[TrainState] = None

    # ------------------------------------------------------------- state
    def _fresh_state(self) -> TrainState:
        state, _axes = init_train_state(self.tc.seed, self.cfg,
                                        device=self.device)
        return state

    def _save(self, state: TrainState, step: int) -> None:
        if not self.tcfg.ckpt_dir:
            return
        if self.tcfg.tmr_replicas:
            tmr_store.save(state, self.tcfg.ckpt_dir, step,
                           replicas=self.tcfg.tmr_replicas)
        else:
            ckpt.save(state, self.tcfg.ckpt_dir, step)

    def _restore(self, proto: TrainState) -> tuple[TrainState, int]:
        if not self.tcfg.ckpt_dir:
            return proto, 0
        try:
            if self.tcfg.tmr_replicas:
                state, step, healed = tmr_store.restore(proto,
                                                        self.tcfg.ckpt_dir)
                if healed:
                    self.log(f"[trainer] TMR healed {healed} replica(s)")
            else:
                state, step = ckpt.restore(proto, self.tcfg.ckpt_dir)
            self.log(f"[trainer] restored step {step}")
            return state, step
        except FileNotFoundError:
            return proto, 0

    # --------------------------------------------------------------- run
    def run(self, steps: int) -> list[dict]:
        self._state = None
        self._state, step = self._restore(self._fresh_state())
        restarts = 0
        while step < steps:
            try:
                step = self._run_span(step, steps)
                return self.history
            except SimulatedFailure as e:
                restarts += 1
                self.log(f"[trainer] FAILURE: {e}; restart {restarts}")
                if restarts > self.tcfg.max_restarts:
                    raise
                self._state = None
                self._state, step = self._restore(self._fresh_state())
        return self.history

    def _run_span(self, step: int, steps: int) -> int:
        """Steps ``step`` .. ``steps - 1`` from ``self._state``."""
        while step < steps:
            self.failures.check(step)
            batch = self.loader.batch(step)
            t0 = time.time()
            self._state, metrics = self.step_fn(self._state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.stragglers.record(0, dt)
            self.history.append({"step": step, "loss": loss, "time_s": dt})
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self._save(self._state, step)
        self._save(self._state, step)
        return step
