"""``sim``: the behavioural device-model backend.

Executes every op through :class:`repro_torch.core.subarray.Subarray`
command sequences — the same APA/PRE/ACT streams the paper issues — with
the calibrated :class:`~repro_torch.core.errormodel.ErrorModel` injecting
deterministic per-cell errors (``ctx.ideal=True`` disables injection for
pure-semantics runs).  Bulk (R, C) tiles are spread round-robin over a
pool of subarrays so row-images land on independent row groups, exactly
like the paper's per-subarray characterization.

The subarrays' planes and their stable-cell masks live on ``ctx.device``
(the card unless the context names another); the sim launches none of
the hand-written kernels — its MAJX is the charge-share majority of the
Subarray model, and its mismatch count is the plain version, as the
reference's is.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backends.base import Backend, Capabilities
from repro_torch.core import calibration as cal
from repro_torch.core import majx as mj
from repro_torch.core import rowcopy as rc
from repro_torch.core.costmodel import COST
from repro_torch.core.subarray import DeviceProfile, Subarray
from repro_torch.kernels.mismatch.ref import mismatch_count_ref

_PROFILES = {"H": DeviceProfile.mfr_h, "M": DeviceProfile.mfr_m,
             "S": DeviceProfile.mfr_s}

#: Subarrays per plane width: row-images of a bulk tile rotate over these
#: (independent stable-cell masks, like testing several random subarrays).
_POOL_SIZE = 4


class SimBackend(Backend):
    name = "sim"

    def __init__(self, ctx=None):
        super().__init__(ctx)
        self._pools: dict[int, list[Subarray]] = {}
        self._rr = 0  # round-robin cursor over the pool
        #: Per-(kind, x, n_act) command energy, memoized — the context
        #: (and so the calibration point) is frozen for this backend's
        #: lifetime, so each command's Fig. 5 energy is a constant.
        self._energy_cache: dict[tuple[str, int, int], float] = {}

    def _accrue(self, kind: str, *, x: int = 0, n_act: int = 0) -> None:
        """Accrue one DRAM command's Fig. 5 energy (retry-aware under
        this context's calibration point; single-issue when ideal)."""
        key = (kind, x, n_act)
        e = self._energy_cache.get(key)
        if e is None:
            errors = None if self.ctx.ideal else self.ctx.error_model
            e = COST.energy_nj(kind, x=x, n_act=n_act, errors=errors,
                               **self.ctx.env())
            self._energy_cache[key] = e
        self.energy_nj_total += e

    def capabilities(self) -> Capabilities:
        anchor = cal.DEVICE_ANCHORS[self.ctx.mfr]
        return Capabilities(
            name=self.name,
            description="behavioural Subarray command model with the "
                        "calibrated per-cell error surfaces",
            stochastic=not self.ctx.ideal,
            device_model=True,
            accelerated=False,
            max_majx=anchor.max_majx if not self.ctx.ideal else 9,
            n_act_levels=cal.N_ACT_LEVELS,
            native_batch=False,
        )

    # ------------------------------------------------------------ plumbing
    def _subarray(self, n_words: int) -> Subarray:
        pool = self._pools.get(n_words)
        if pool is None:
            profile = _PROFILES[self.ctx.mfr]()
            pool = [
                Subarray(profile, cols=n_words * 32, temp_c=self.ctx.temp_c,
                         vpp_v=self.ctx.vpp_v, ideal=self.ctx.ideal,
                         seed=self.ctx.seed * 1009 + i, device=self.device)
                for i in range(_POOL_SIZE)
            ]
            self._pools[n_words] = pool
        sa = pool[self._rr % len(pool)]
        self._rr += 1
        return sa

    def _per_row(self, fn, plane) -> torch.Tensor:
        """Apply a (words,)->(...) op to a (words,) or (R, C) row set."""
        plane = self.words(plane)
        if plane.ndim == 1:
            return fn(plane)
        return torch.stack([fn(row) for row in plane])

    # ------------------------------------------------------------- bulk ops
    def majx(self, planes, x: Optional[int] = None,
             n_act: Optional[int] = None) -> torch.Tensor:
        planes = self.words(planes)
        x = x or planes.shape[0]
        n = n_act or max(self.ctx.n_act, cal.min_activation_for(x))
        if n < x:
            n = cal.min_activation_for(x)
        t = self.ctx.timings

        def one(stack: torch.Tensor) -> torch.Tensor:  # (X, words)
            self._accrue("MAJ", x=x, n_act=n)
            sa = self._subarray(stack.shape[-1])
            return mj.majx(sa, list(stack), n, t1_ns=t.majx_t1,
                           t2_ns=t.majx_t2, pattern=self.ctx.pattern)

        if planes.ndim == 2:
            return one(planes)
        # (X, R, C): each r is an independent row image.
        return torch.stack([one(planes[:, r, :])
                            for r in range(planes.shape[1])])

    def rowcopy(self, src, n_dst: int) -> torch.Tensor:
        t = self.ctx.timings

        def one(row: torch.Tensor) -> torch.Tensor:  # (words,) -> (n_dst, words)
            sa = self._subarray(row.shape[-1])
            out, base = [], 0
            while len(out) < n_dst:
                remaining = n_dst - len(out)
                n_act = max(l for l in cal.N_ACT_LEVELS
                            if l <= remaining + 1)
                self._accrue("MRC", n_act=n_act)
                _, dests = rc.multi_rowcopy(sa, row, n_act, t1_ns=t.mrc_t1,
                                            t2_ns=t.mrc_t2, base_row=base)
                out.extend(sa.read_row(d) for d in dests[:remaining])
                base += n_act
            return torch.stack(out)

        src = self.words(src)
        if src.ndim == 1:
            return one(src)
        # (R, C) -> (n_dst, R, C)
        per_row = [one(row) for row in src]          # R x (n_dst, C)
        return torch.stack(per_row, dim=1)

    def mismatch(self, a, b) -> torch.Tensor:
        # Success-rate measurement happens off-device in the paper's
        # harness (read-back + host compare); the digital count is exact.
        return mismatch_count_ref(self.words(a).reshape(-1),
                                  self.words(b).reshape(-1))

    def add_planes(self, a, b) -> torch.Tensor:
        from repro_torch.pud.arith import BitSerial

        bs = BitSerial(tier=self.ctx.tier, n_act=self.ctx.n_act,
                       executor=self)
        out, _ = bs.add(self.words(a), self.words(b))
        return out

    # ------------------------------------------------- device-model hooks
    def _copy(self, plane) -> torch.Tensor:
        def one(row: torch.Tensor) -> torch.Tensor:
            self._accrue("COPY")
            sa = self._subarray(row.shape[-1])
            sa.write_row(0, row)
            rc.rowclone(sa, 0, 1)
            return sa.read_row(1)

        return self._per_row(one, plane)

    def _not(self, plane) -> torch.Tensor:
        # NOT is a complement-row copy (Ambit-style): clone the staged
        # complement so the op pays RowClone error semantics.
        def one(row: torch.Tensor) -> torch.Tensor:
            self._accrue("NOT")
            sa = self._subarray(row.shape[-1])
            sa.write_row(0, ~row)
            rc.rowclone(sa, 0, 1)
            return sa.read_row(1)

        return self._per_row(one, plane)

    def _frac(self, dsts: torch.Tensor, state: torch.Tensor) -> None:
        self._accrue("FRAC")
        super()._frac(dsts, state)

    def _exec_op(self, op, state: torch.Tensor) -> None:
        # Row I/O is value-neutral in the image but not in joules: the
        # bus transfer pays WR/RD power for the full row time (Fig. 5).
        if op.kind in ("WR", "RD"):
            self._accrue(op.kind)
        super()._exec_op(op, state)
