"""Elastic scaling: re-mesh surviving devices and reshard state.

Flow on node loss (or scale-up): checkpoint (or live state) -> build a new
mesh from the surviving device set -> recompute Shardings from the
*same logical axes* -> place the tensors -> resume.  Because shardings
derive from logical axes, no per-tensor surgery is needed; the data
pipeline is step-keyed so the batch stream continues exactly.

`plan_remesh` chooses the largest (data x model) grid that preserves the
model axis (TP degree is an algorithmic choice; DP shrinks with capacity).
Placement follows :meth:`repro_torch.dist.sharding.Sharding.place`: on a
mesh of one device every tensor moves to it; a tree laid out over
several cards raises (ROADMAP queue 1, multi-card placement).
"""

from __future__ import annotations

from typing import Optional, Sequence, TypeVar

import numpy as np

from repro_torch.core import tree as tree_util
from repro_torch.dist.sharding import (AxisRules, DEFAULT_RULES, Mesh,
                                       tree_shardings)

_T = TypeVar("_T")


class ElasticMembership:
    """Live-worker roster with deterministic shard (re)planning.

    The sweep engine's fault-tolerant runner
    (:func:`repro_torch.sweep.runner.run_sweep_ft`) partitions pending
    chunks round-robin across the *live* workers — the same deterministic
    rule as :func:`repro_torch.sweep.planner.shard` — and replans whenever
    membership changes: a dropped worker's share is automatically
    redistributed because the partition is a pure function of
    ``(items, live roster)``.  ``generation`` increments on every
    membership change, so long-lived holders of a partition can detect
    staleness without comparing rosters.
    """

    def __init__(self, n_workers: int):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self._live: list[int] = list(range(n_workers))
        self.dropped: list[int] = []
        self.generation = 0

    @property
    def live(self) -> tuple[int, ...]:
        return tuple(self._live)

    def is_live(self, worker: int) -> bool:
        return worker in self._live

    def drop(self, worker: int) -> None:
        """Remove a worker from the roster (idempotent)."""
        if worker in self._live:
            self._live.remove(worker)
            self.dropped.append(worker)
            self.generation += 1

    def join(self, worker: int) -> None:
        """(Re-)admit a worker; the partition replans around it."""
        if worker not in self._live:
            self._live.append(worker)
            self._live.sort()
            if worker in self.dropped:
                self.dropped.remove(worker)
            self.generation += 1

    def plan(self, items: Sequence[_T]) -> dict[int, list[_T]]:
        """Round-robin partition of ``items`` over the live roster."""
        out: dict[int, list[_T]] = {w: [] for w in self._live}
        for i, item in enumerate(items):
            out[self._live[i % len(self._live)]].append(item)
        return out

    def share(self, items: Sequence[_T], worker: int) -> list[_T]:
        """One live worker's slice of the current partition."""
        if worker not in self._live:
            return []
        return self.plan(items)[worker]


def plan_remesh(n_devices: int, model_parallel: int,
                pods: int = 1) -> tuple[int, ...]:
    """Largest usable (pods, data, model) grid on the surviving devices."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than the TP degree; cannot remesh")
    per_pod = n_devices // max(pods, 1)
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("not enough devices per pod for one data replica")
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def make_mesh_from(devices, shape: tuple[int, ...]) -> Mesh:
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    grid = np.empty(n, dtype=object)
    grid[:] = list(devices[:n])
    return Mesh(grid.reshape(shape), names)


def reshard(tree, axes_tree, new_mesh: Mesh,
            rules: AxisRules = DEFAULT_RULES):
    """Place a live tree onto a new mesh by its logical axes."""
    shardings = tree_util.flatten(tree_shardings(axes_tree, new_mesh,
                                                 rules))[0]
    leaves, structure = tree_util.flatten(tree)
    if len(shardings) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(shardings)} axes "
                         f"annotations")
    return tree_util.unflatten(
        structure, [s.place(x) for s, x in zip(shardings, leaves)])


def elastic_restart(tree_like, axes_tree, ckpt_dir: str, devices,
                    model_parallel: int, pods: int = 1,
                    step: Optional[int] = None):
    """Restore the latest checkpoint onto a fresh mesh over ``devices``."""
    from repro_torch.ckpt import checkpoint as ckpt

    shape = plan_remesh(len(devices), model_parallel, pods)
    mesh = make_mesh_from(devices, shape)
    tree, found = ckpt.restore(tree_like, ckpt_dir, step)
    return reshard(tree, axes_tree, mesh), mesh, found
