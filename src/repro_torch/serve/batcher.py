"""Continuous batching: coalesce a tick's requests into fused Programs.

The schedule :class:`~repro_torch.session.cache.CompileCache` already
makes a *repeated* program shape nearly free; this module makes
*concurrent* requests share one program in the first place — the
Orca/vLLM continuous-batching idea applied to fused PUD programs.  Per
batching tick, requests with equal :meth:`~repro_torch.serve.queue.
PudRequest.coalesce_key` merge into ONE addressed Program built through
the typed :class:`~repro_torch.session.builder.SessionProgram`:

* **heal** — every request's replica tiles concatenate row-wise into X
  input groups; one MAJ per row-image votes into a shared output group.
  All ops are independent, so the schedule is a single level and the
  ``cuda`` backend executes N tenants' votes as ONE batched MAJX
  launch.  Each heal's ``fixed_bits`` is one mismatch launch of its
  voted tile against its replica-0 rows *of the executed image*: the
  tick's ops write only the output group, so those rows hold the
  request's replica 0 bit for bit, already on the device (the
  reference uploads ``replicas[0]`` a second time instead).
* **erase** — one WR'd pattern row fans out in Multi-RowCopy waves over
  every request's rows; again a single level, one fused fan-out launch.
* **verify** — ``mismatch`` is a scalar reduction per request (no
  per-request split of a fused result), so integrity checks share the
  tick and session but execute one bulk op each.

Result tiles are gathered from the final image on the session's device
and stay there (int32 tensors of the uint32 bit patterns); the image is
never copied to the host.  Coalesced execution is bit-exact with
per-request execution on every backend (``tests/test_torch_serve.py``
holds both to the reference), so batching is purely a throughput /
dispatch-count optimization — under a steady request mix the coalesced
program repeats shape tick over tick and the schedule cache makes it
1 miss + N-1 hits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import calibration as cal
from repro_torch.serve.queue import (EraseRequest, EraseResult, HealRequest,
                                     HealResult, IntegrityRequest,
                                     IntegrityResult, PudRequest)


def _rows(final: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``group`` gathered from ``final``, on its device."""
    return final[torch.as_tensor(group.indices, device=final.device)]


@dataclasses.dataclass
class BatchPlan:
    """One coalesced group: requests sharing a fused Program this tick."""

    key: tuple
    requests: list[PudRequest]

    @property
    def kind(self) -> str:
        return self.key[0]

    def __len__(self) -> int:
        return len(self.requests)


@dataclasses.dataclass
class BatchOutcome:
    """Execution record of one plan: per-request results + metadata."""

    plan: BatchPlan
    results: list
    n_ops: int          # fused Program size (0 for direct bulk ops)
    n_levels: int       # schedule depth (0 for direct bulk ops)


class Batcher:
    """Groups a tick's drained requests and executes each group.

    ``coalesce=False`` degrades every group to a single request — the
    sequential baseline the serve bench compares against; the programs
    built either way are identical in semantics, so the comparison
    isolates the batching win.
    """

    def __init__(self, coalesce: bool = True):
        self.coalesce = coalesce

    # ------------------------------------------------------------- planning
    def plan(self, requests: list[PudRequest]) -> list[BatchPlan]:
        """Group by coalesce key, preserving first-arrival order."""
        if not self.coalesce:
            return [BatchPlan(r.coalesce_key(), [r]) for r in requests]
        groups: dict[tuple, BatchPlan] = {}
        for req in requests:
            key = req.coalesce_key()
            if key not in groups:
                groups[key] = BatchPlan(key, [])
            groups[key].requests.append(req)
        return list(groups.values())

    # ------------------------------------------------------------ execution
    def execute(self, plan: BatchPlan, session) -> BatchOutcome:
        """Run one plan on ``session`` (synchronous, fused, cached)."""
        if plan.kind == "heal":
            return self._execute_heal(plan, session)
        if plan.kind == "erase":
            return self._execute_erase(plan, session)
        if plan.kind == "verify":
            return self._execute_verify(plan, session)
        raise ValueError(f"unknown batch kind {plan.kind!r}")

    def _execute_heal(self, plan: BatchPlan, session) -> BatchOutcome:
        from repro_torch.pud.offload import plan_program

        reqs: list[HealRequest] = plan.requests
        _, x, words, n_act = plan.key
        n_act = cal.min_activation_for(
            max(n_act or max(cal.N_ACT_LEVELS), x))
        row_counts = [r.rows for r in reqs]
        total = sum(row_counts)
        b = session.program(rows=(x + 1) * total,
                            name=f"serve/heal-x{x}")
        groups = [
            b.input(np.concatenate([r.replicas[j] for r in reqs]),
                    tag=f"serve/heal/replica[{j}]")
            for j in range(x)
        ]
        out = b.alloc_rows(total, tag="serve/heal/voted")
        for r in range(total):
            b.maj(*(g[r] for g in groups), dst=out[r], n_act=n_act,
                  tag=f"serve/heal/row[{r}]")
        prog = b.build()
        final = session.run_fused(prog, b.initial_state())
        voted = _rows(final, out)
        replica0 = _rows(final, groups[0])
        del final
        sched = session.schedule_for(prog)  # cache hit, not a re-leveling
        decision = plan_program(prog, words * 4, ctx=session.ctx,
                                sched=sched)
        results, off = [], 0
        for req, rows in zip(reqs, row_counts):
            tile = voted[off:off + rows]
            fixed = int(session.mismatch(replica0[off:off + rows], tile))
            off += rows
            results.append(HealResult(healed=tile, fixed_bits=fixed,
                                      decision=decision))
        return BatchOutcome(plan, results, n_ops=len(prog.ops),
                            n_levels=sched.n_levels)

    def _execute_erase(self, plan: BatchPlan, session) -> BatchOutcome:
        reqs: list[EraseRequest] = plan.requests
        _, words, pattern, fanout = plan.key
        total = sum(r.rows for r in reqs)
        b = session.program(rows=total + 1, name=f"serve/erase-f{fanout}")
        src = b.input(np.full(words, pattern, np.uint32),
                      tag="serve/erase/pattern")
        dsts = b.alloc_rows(total, tag="serve/erase/wiped")
        for lo in range(0, total, fanout):
            b.mrc(src, dsts[lo:lo + fanout],
                  tag=f"serve/erase/wave[{lo // fanout}]")
        prog = b.build()
        final = session.run_fused(prog, b.initial_state())
        wiped = _rows(final, dsts)
        results, off = [], 0
        for req in reqs:
            results.append(EraseResult(wiped=wiped[off:off + req.rows]))
            off += req.rows
        return BatchOutcome(plan, results, n_ops=len(prog.ops),
                            n_levels=session.schedule_for(prog).n_levels)

    def _execute_verify(self, plan: BatchPlan, session) -> BatchOutcome:
        results = []
        for req in plan.requests:
            assert isinstance(req, IntegrityRequest)
            bad = int(session.mismatch(req.live, req.reference))
            results.append(IntegrityResult(
                mismatch_bits=bad, total_bits=int(req.live.size) * 32))
        return BatchOutcome(plan, results, n_ops=0, n_levels=0)
