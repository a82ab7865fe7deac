"""DRAM command-sequence IR (the DRAM Bender programs of §3).

The paper drives real chips with precisely-timed command sequences; our
behavioural simulator consumes the same IR.  A :class:`CommandSeq` is a list
of commands with explicit inter-command delays in nanoseconds — violated
timings are simply small delays (the whole point of the paper).

Standard JEDEC DDR4 timing parameters (used as the *nominal* reference and
by the latency model in :mod:`repro_torch.pud.latency`) are bundled as
:class:`Timings`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Timings:
    """Nominal DDR4 timing parameters (ns), DDR4-2400-ish (JESD79-4)."""

    tck: float = 0.833
    tras: float = 36.0  # ACT -> PRE (also the MRC t1 optimum, Obs 14)
    trp: float = 15.0   # PRE -> ACT
    trcd: float = 15.0  # ACT -> RD/WR
    trc: float = 51.0   # ACT -> ACT (same bank)
    twr: float = 15.0   # write recovery
    tbl: float = 3.33   # burst (BL8 @ 2400)
    trfc: float = 350.0  # refresh cycle (8Gb-class)
    trefi: float = 7800.0
    #: DRAM Bender command-slot granularity (§9 Limitation 2): 1.5 ns.
    slot: float = 1.5


NOMINAL = Timings()


@dataclasses.dataclass(frozen=True)
class Cmd:
    kind: str  # ACT | PRE | WR | RD | NOP
    row: Optional[int] = None
    #: packed uint32 payload for WR; None elsewhere
    data: Optional[np.ndarray] = None
    #: delay (ns) before the *next* command may issue
    gap_ns: float = 0.0

    def __repr__(self) -> str:  # compact traces in logs/tests
        r = f" r{self.row}" if self.row is not None else ""
        return f"{self.kind}{r}@{self.gap_ns}ns"


@dataclasses.dataclass
class CommandSeq:
    """An ordered DRAM command program with explicit timing."""

    cmds: list[Cmd] = dataclasses.field(default_factory=list)

    def act(self, row: int, gap_ns: float) -> "CommandSeq":
        self.cmds.append(Cmd("ACT", row=row, gap_ns=gap_ns))
        return self

    def pre(self, gap_ns: float) -> "CommandSeq":
        self.cmds.append(Cmd("PRE", gap_ns=gap_ns))
        return self

    def wr(self, data: np.ndarray, gap_ns: float = NOMINAL.twr) -> "CommandSeq":
        self.cmds.append(Cmd("WR", data=np.asarray(data, np.uint32), gap_ns=gap_ns))
        return self

    def rd(self, row: int, gap_ns: float = NOMINAL.tbl) -> "CommandSeq":
        self.cmds.append(Cmd("RD", row=row, gap_ns=gap_ns))
        return self

    def nop(self, gap_ns: float) -> "CommandSeq":
        self.cmds.append(Cmd("NOP", gap_ns=gap_ns))
        return self

    def extend(self, other: Union["CommandSeq", Iterable[Cmd]]) -> "CommandSeq":
        self.cmds.extend(other.cmds if isinstance(other, CommandSeq) else other)
        return self

    @property
    def duration_ns(self) -> float:
        return sum(c.gap_ns for c in self.cmds)

    def __len__(self) -> int:
        return len(self.cmds)

    def __iter__(self):
        return iter(self.cmds)


# ---------------------------------------------------------------------------
# canonical sequences from the paper
# ---------------------------------------------------------------------------


def apa(row_first: int, row_second: int, t1_ns: float, t2_ns: float) -> CommandSeq:
    """ACT R_F --t1--> PRE --t2--> ACT R_S  (§2.2, §3.2).

    t1 violates tRAS and t2 violates tRP; the trailing gap closes the row
    cycle at nominal timing so subsequent commands are safe.
    """
    seq = CommandSeq()
    seq.act(row_first, gap_ns=t1_ns)
    seq.pre(gap_ns=t2_ns)
    seq.act(row_second, gap_ns=NOMINAL.tras)
    return seq


def apa_with_wr(
    row_first: int, row_second: int, t1_ns: float, t2_ns: float,
    data: np.ndarray,
) -> CommandSeq:
    """§3.2 SiMRA test: APA then WR overdrives all simultaneously open rows."""
    seq = apa(row_first, row_second, t1_ns, t2_ns)
    seq.wr(data)
    seq.pre(gap_ns=NOMINAL.trp)
    return seq


def rowclone(src: int, dst: int) -> CommandSeq:
    """Consecutive two-row activation (fn 6): ACT src -> PRE(6ns) -> ACT dst."""
    seq = CommandSeq()
    seq.act(src, gap_ns=NOMINAL.tras)
    seq.pre(gap_ns=6.0)
    seq.act(dst, gap_ns=NOMINAL.tras)
    seq.pre(gap_ns=NOMINAL.trp)
    return seq


def multi_rowcopy(src: int, row_second: int, t2_ns: float = 3.0) -> CommandSeq:
    """§3.4: ACT src --tRAS--> PRE --t2<=3ns--> ACT r_s: 1 -> N-1 copy."""
    seq = CommandSeq()
    seq.act(src, gap_ns=NOMINAL.tras)
    seq.pre(gap_ns=t2_ns)
    seq.act(row_second, gap_ns=NOMINAL.tras)
    seq.pre(gap_ns=NOMINAL.trp)
    return seq


def frac(row: int) -> CommandSeq:
    """FracDRAM-style neutral-row initialization (§2.2, fn 4).

    Charges the row to ~VDD/2 by interrupting restoration: ACT followed by
    an early PRE mid-restore.  We model the outcome (a neutral row), not the
    analog trajectory.
    """
    seq = CommandSeq()
    seq.act(row, gap_ns=9.0)   # interrupted restore
    seq.pre(gap_ns=NOMINAL.trp)
    return seq
