"""PUDDevice: a bank/subarray-structured device executing PUD programs.

Composes the behavioural :class:`~repro_torch.core.subarray.Subarray` model
into the module-level geometry of Table 1 (banks x subarrays), with
operation scheduling, latency/energy accounting, and row allocation.  This
is the "device" the §5/§6 characterization drives.  Its subarrays' planes
live on ``DeviceConfig.device`` (the card unless the config names another).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.errormodel import ErrorModel
from repro_torch.core.subarray import DeviceProfile, Subarray
from repro_torch.core import majx as mj
from repro_torch.core import rowcopy as rc
from repro_torch.pud.isa import Program
from repro_torch.pud import latency as lat


@dataclasses.dataclass
class DeviceConfig:
    profile: DeviceProfile = dataclasses.field(default_factory=DeviceProfile.mfr_h)
    n_banks: int = 16
    subarrays_per_bank: int = 3  # the paper tests 3 random subarrays/bank
    cols: int = 1024
    temp_c: float = 50.0
    vpp_v: float = 2.5
    ideal: bool = False
    #: where every subarray's planes and stable-cell masks live
    device: str = "cuda"


class PUDDevice:
    """A (small, simulated) DRAM module capable of PUD operations."""

    def __init__(self, config: Optional[DeviceConfig] = None, seed: int = 0):
        self.config = config or DeviceConfig()
        c = self.config
        self.subarrays = [
            Subarray(c.profile, c.cols, temp_c=c.temp_c, vpp_v=c.vpp_v,
                     seed=seed * 1009 + i, ideal=c.ideal, device=c.device)
            for i in range(c.n_banks * c.subarrays_per_bank)
        ]
        self.errors = ErrorModel(c.profile.mfr)
        self.program = Program()
        self.elapsed_ns = 0.0

    # ------------------------------------------------------------ topology
    def subarray(self, bank: int, index: int = 0) -> Subarray:
        return self.subarrays[bank * self.config.subarrays_per_bank + index]

    @property
    def n_subarrays(self) -> int:
        return len(self.subarrays)

    # ------------------------------------------------------------ PUD ops
    def majx(self, bank: int, operands, n_act: int, **kw) -> torch.Tensor:
        sa = self.subarray(bank)
        out = mj.majx(sa, operands, n_act, **kw)
        x = len(operands)
        self.program.emit("MAJ", x=x, n_act=n_act, tag=f"bank{bank}")
        self.elapsed_ns += lat.majx_issue_ns(x, n_act)
        return out

    def multi_rowcopy(self, bank: int, src_data, n_act: int, **kw):
        sa = self.subarray(bank)
        out = rc.multi_rowcopy(sa, src_data, n_act, **kw)
        self.program.emit("MRC", n_act=n_act, tag=f"bank{bank}")
        self.elapsed_ns += lat.LAT.mrc
        return out

    def rowclone(self, bank: int, src: int, dst: int) -> None:
        rc.rowclone(self.subarray(bank), src, dst)
        self.program.emit("COPY", tag=f"bank{bank}")
        self.elapsed_ns += lat.LAT.rowclone

    def broadcast_fanout(self, bank: int, src_data, n_rows: int) -> list[int]:
        """Replicate one row image to ``n_rows`` rows with a fan-out tree.

        Uses the widest Multi-RowCopy the decoder supports per step —
        the framework's model of the paper's 1->31 fan-out primitive, and
        the building block of the checkpoint-restore replication path.
        """
        sa = self.subarray(bank)
        done: list[int] = []
        base = 0
        while len(done) < n_rows:
            n_act = 32
            while n_act > 2 and len(done) + (n_act - 1) > n_rows + 31:
                n_act //= 2
            src_row, dests = rc.multi_rowcopy(sa, src_data, n_act, base_row=base)
            self.program.emit("MRC", n_act=n_act, tag=f"bank{bank}/fanout")
            self.elapsed_ns += lat.LAT.mrc
            done.extend(dests[: n_rows - len(done)])
            base += n_act
            if base + n_act > sa.rows:
                break
        return done

    # -------------------------------------------------------- accounting
    def energy_nj(self) -> float:
        return self.program.energy_nj(self.errors)

    def stats(self) -> dict:
        return {
            "elapsed_ns": self.elapsed_ns,
            "ops": len(self.program.ops),
            "histogram": self.program.histogram(),
            "energy_nj": self.energy_nj(),
        }
