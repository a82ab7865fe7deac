"""Op-level RowClone / Multi-RowCopy / Frac (paper §3.4, §6).

Multi-RowCopy testing flow (§3.4): initialize destinations with one pattern,
the source with another, issue ACT(src) --tRAS--> PRE --t2<=3ns--> ACT(r_s),
then read each destination at nominal timings.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.core import commands as cmd
from repro_torch.core.subarray import Subarray


def rowclone(sa: Subarray, src: int, dst: int) -> None:
    """Copy one row to one other row via consecutive activation (fn 6)."""
    sa.run(cmd.rowclone(src, dst))


def multi_rowcopy(
    sa: Subarray,
    src_data: torch.Tensor,
    n_act: int,
    *,
    t1_ns: float = cal.MRC_BEST_T1_NS,
    t2_ns: float = cal.MRC_BEST_T2_NS,
    base_row: int = 0,
) -> tuple[int, tuple[int, ...]]:
    """Copy ``src_data`` to the N-1 other rows of an N-row activation group.

    Returns (source_row, destination_rows).  The source row is R_F of the
    APA pair; destinations are the remaining activated rows.
    """
    rf, rs = sa.decoder.pair_for_n_rows(n_act, base_row)
    group = sa.decoder.apa_activated_rows(rf, rs)
    sa.write_row(rf, src_data)
    seq = cmd.CommandSeq()
    seq.act(rf, gap_ns=t1_ns)
    seq.pre(gap_ns=t2_ns)
    seq.act(rs, gap_ns=cmd.NOMINAL.tras)
    seq.pre(gap_ns=cmd.NOMINAL.trp)
    sa.run(seq)
    dests = tuple(r for r in group if r != rf)
    return rf, dests


def mrc_success_measured(
    sa: Subarray, src_data: torch.Tensor, n_act: int, **kw
) -> float:
    """Fraction of destination cells holding the source data after MRC."""
    src_data = sa._words(src_data)
    _, dests = multi_rowcopy(sa, src_data, n_act, **kw)
    total = ok = 0
    for d in dests:
        same = ~(sa.read_row(d) ^ src_data)
        ok += int(torch.sum(bp.popcount(same)))
        total += sa.n_words * 32
    return ok / total


def frac_init(sa: Subarray, rows: Sequence[int]) -> None:
    """Neutral-row (VDD/2) initialization for each row (FracDRAM, §2.2)."""
    for r in rows:
        sa.run(cmd.frac(r))
