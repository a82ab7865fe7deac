"""``cuda``: the hand-written CUDA kernel backend.

Launches the kernels of :mod:`repro_torch.kernels` (bit-sliced CSA MAJX,
fan-out Multi-RowCopy, the whole-schedule megakernel, the mismatch
count behind :meth:`success_rate`, the bit-serial adder behind
:meth:`add_planes`) on state tensors
that live on ``ctx.device`` — the card by default.  With
``ExecutionContext(device="cpu")`` every wrapper computes with its plain
PyTorch version instead, which is how the tests run it without a card;
dispatch and energy accounting are identical on both devices.

Program execution: :meth:`run_fused` overrides the per-op interpreter
with the :mod:`repro_torch.compile` schedule — every dependency level of
the program becomes at most one MAJX launch (mixed arities padded with
constant 0/1 plane pairs, an exact identity) plus at most one fan-out
launch, while NOT/COPY levels are plain gather/scatter with no kernel.
``run_fused(mode="megakernel")`` lowers the whole schedule to static
level tables (:mod:`repro_torch.compile.megakernel`) whose execution
plan (the live slots only) ONE launch executes end-to-end.
``self.dispatch_count`` counts launches, and each accrues
:data:`repro_torch.core.costmodel.COST`-priced energy (launch
round-trip at board power + device-memory traffic).

§8.1 arithmetic (:meth:`elementwise`) takes the fused path: the gate
stream is traced into one addressed Program (:mod:`repro_torch.compile.
trace`) and run by :meth:`run_fused`, so its kernels are MAJX (and the
megakernel when asked for); the bulk adder :meth:`add_planes` is one
bit-serial launch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.backends.base import Backend, Capabilities
from repro_torch.compile.megakernel import lower_schedule
from repro_torch.compile.schedule import build_schedule
from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.core.costmodel import COST
from repro_torch.kernels.bitserial import ops as bitserial_ops
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.plan import plan_for
from repro_torch.kernels.mismatch import ops as mismatch_ops
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from repro_torch.pud.isa import Program


class CudaBackend(Backend):
    name = "cuda"

    def __init__(self, ctx=None):
        super().__init__(ctx)
        #: Execution plans on ``self.device``, by their key (derived from
        #: ``MegaLowering.digest()``): each lowering is planned, hashed
        #: and uploaded once, not once per run.
        self._tables: dict[str, mega_ops.DeviceTables] = {}

    def capabilities(self) -> Capabilities:
        return Capabilities(
            name=self.name,
            description="hand-written CUDA kernels for Hopper (CSA "
                        "bit-sliced MAJX, fan-out MRC, megakernel, "
                        "mismatch count, bit-serial adder)",
            stochastic=False,
            device_model=False,
            accelerated=True,
            max_majx=1_000_000,
            n_act_levels=cal.N_ACT_LEVELS,
            native_batch=True,
            megakernel=True,
        )

    def _launch(self, n_bytes: float) -> None:
        """Account one kernel launch: bump the dispatch counter and
        accrue its CostModel energy — the launch round-trip at board
        power plus the access energy of the kernel's ``n_bytes`` of
        operand + result traffic."""
        self.dispatch_count += 1
        self.energy_nj_total += (COST.dispatch_energy_nj(1)
                                 + COST.hbm_energy_nj(n_bytes))

    def majx(self, planes, x: Optional[int] = None,
             n_act: Optional[int] = None) -> torch.Tensor:
        planes = self.words(planes)
        self._launch((planes.numel() + planes[0].numel()) * 4)
        return majx_ops.majx(planes.contiguous(),
                             threads=self.ctx.threads_per_block)

    def majx_batch(self, planes) -> torch.Tensor:
        """(B, X, R, C) -> (B, R, C) in one kernel launch."""
        planes = self.words(planes)
        self._launch((planes.numel() + planes.numel() // planes.shape[1])
                     * 4)
        return majx_ops.majx_batch(planes.contiguous(),
                                   threads=self.ctx.threads_per_block)

    def rowcopy(self, src, n_dst: int) -> torch.Tensor:
        src = self.words(src)
        self._launch(src.numel() * (1 + n_dst) * 4)
        return rowcopy_ops.fanout(src.contiguous(), n_dst,
                                  threads=self.ctx.threads_per_block)

    def mismatch(self, a, b) -> torch.Tensor:
        """Differing bits of ``a`` and ``b`` in ONE kernel launch: a 0-d
        int32 tensor that wraps past 2**31 as the reference's does."""
        a, b = self.words(a), self.words(b)
        count = mismatch_ops.mismatch_count(   # raises before a launch
            a.contiguous(), b.contiguous(),    # on unequal sizes
            threads=self.ctx.threads_per_block)
        self._launch((a.numel() + b.numel()) * 4)
        return count

    def add_planes(self, a, b) -> torch.Tensor:
        """Ripple-carry sum of two (NBITS, ...) plane stacks in ONE
        kernel launch (accounted ``3 * a.numel() * 4`` bytes: both
        operands in, the sum out)."""
        a, b = self.words(a), self.words(b)
        out = bitserial_ops.bitserial_add(     # raises before a launch
            a.contiguous(), b.contiguous(),    # on unequal shapes
            threads=self.ctx.threads_per_block)
        self._launch(3 * a.numel() * 4)
        return out

    # ------------------------------------------------- fused program path
    def run_fused(self, program: Program, state, *, sched=None,
                  mode: str = "fused", lowering=None) -> torch.Tensor:
        """Level-batched program execution (see module docstring).

        Each level's groups all read the level-entry state and their
        writes are applied after the whole level is computed, matching
        the hazard model the scheduler levels against; WAW leveling
        guarantees the per-level scatters hit disjoint rows.  Prebuilt
        ``sched`` / ``lowering`` artifacts skip the scheduling and
        lowering passes.  The caller's tensor is never written.

        ``mode="megakernel"`` routes to :meth:`run_megakernel` — the
        whole schedule in one launch.
        """
        if mode == "megakernel":
            return self.run_megakernel(program, state, sched=sched,
                                       lowering=lowering)
        if mode != "fused":
            raise ValueError(f"unknown run_fused mode {mode!r}")
        if sched is None:
            sched = build_schedule(program)
        state = self.words(state).clone()
        for level in sched.levels:
            writes = [self._exec_group(group, state) for group in level]
            for dsts, vals in writes:
                state[dsts] = vals
        return state

    def run_megakernel(self, program: Program, state, *, sched=None,
                       lowering=None) -> torch.Tensor:
        """The whole schedule in ONE kernel launch.

        Value-neutral programs (no write slots) are the identity at zero
        launches — there is nothing to launch, matching what the empty
        fused walk does.
        """
        if lowering is None:
            if sched is None:
                sched = build_schedule(program)
            lowering = lower_schedule(sched)
        state = self.words(state)
        if lowering.n_levels == 0 or lowering.w_max == 0:
            return state.clone()
        key = plan_for(lowering).key     # the digest, once per lowering
        tables = self._tables.get(key)
        if tables is None:
            tables = mega_ops.upload_tables(lowering, self.device)
            self._tables[key] = tables
        rows, words = state.shape
        self._launch(2 * rows * words * 4)  # image in + image out
        return mega_ops.run_lowering(lowering, state.contiguous(),
                                     tables=tables)

    def _exec_group(self, group, entry: torch.Tensor):
        """One group's writes, ``(dst row index, values)``, computed
        from the level-entry image without modifying it."""
        if group.kind == "MAJ":
            return self._fused_maj(group, entry)
        if group.kind == "MRC":
            return self._fused_mrc(group, entry)
        # NOT / COPY: one gather (+ complement), no kernel.
        srcs = self._index([op.srcs[0] for op in group.ops
                            for _ in op.dsts])
        dsts = self._index([d for op in group.ops for d in op.dsts])
        vals = entry[srcs]
        return dsts, (~vals if group.kind == "NOT" else vals)

    def _fused_maj(self, group, entry: torch.Tensor):
        """All MAJ ops of a level in ONE kernel launch.

        Narrower ops are padded to the level's widest arity X with
        constant (all-0, all-1) plane *pairs* — each pair adds one to
        the popcount and one to the majority threshold, so
        ``MAJ_k(x..) == MAJ_X(x.., 0*m, 1*m)`` exactly.  The batch is
        laid out (X, B, W): every op is one row of the vote, so a single
        MAJX launch covers the whole level.
        """
        x_max = group.param
        idx = np.zeros((x_max, len(group.ops)), np.int64)
        ones = np.zeros((x_max, len(group.ops)), bool)
        pads = np.zeros((x_max, len(group.ops)), bool)
        for i, op in enumerate(group.ops):
            k = len(op.srcs)
            if (x_max - k) % 2:
                raise ValueError(
                    f"cannot pad MAJ{k} to MAJ{x_max}: parity differs")
            pad = (x_max - k) // 2
            idx[:k, i] = op.srcs
            pads[k:, i] = True
            ones[k + pad:, i] = True
        batch = entry[self._index(idx)]                  # (X, B, W)
        if pads.any():
            batch[torch.as_tensor(pads, device=self.device)] = 0
            batch[torch.as_tensor(ones, device=self.device)] = bp.ONES
        out = self.majx(batch)                           # (B, W), 1 launch
        dsts = self._index([d for op in group.ops for d in op.dsts])
        sel = self._index([i for i, op in enumerate(group.ops)
                           for _ in op.dsts])
        return dsts, out[sel]

    def _fused_mrc(self, group, entry: torch.Tensor):
        """All Multi-RowCopy ops of a level in ONE fan-out launch.

        Sources stack into a (B, W) block; a single fan-out to the widest
        destination count yields (n, B, W), and each op takes the prefix
        of copies its own ``dsts`` ask for (copies are identical, so a
        prefix is exact).
        """
        srcs = self._index([op.srcs[0] for op in group.ops])
        copies = self.rowcopy(entry[srcs], group.param)  # (n, B, W)
        dsts = self._index([d for op in group.ops for d in op.dsts])
        sel_copy = self._index([j for op in group.ops
                                for j in range(len(op.dsts))])
        sel_op = self._index([i for i, op in enumerate(group.ops)
                              for _ in op.dsts])
        return dsts, copies[sel_copy, sel_op]
