"""Seeded mutations of megakernel slot tables — the analyzer's negative gate.

A verifier that has only ever seen correct compiler output is
untested.  This module applies small, *realistic* corruptions to a
:class:`~repro_torch.compile.megakernel.MegaLowering` — each one a bug
class the lowering code could plausibly grow — and the tests assert that
:func:`repro_torch.analyze.cert.certify` rejects every applicable
mutation on every golden fixture.

Each mutation returns a new lowering (the input is never modified) or
``None`` when the artifact has no site for it (e.g. ``drop_inv`` on a
program without NOT ops).  Mutations prefer sites in the *latest*
applicable level so the corruption survives to the final state and the
equivalence pass cannot be masked by a later overwrite.

The six classes and the finding each must trigger:

==================  ====================================================
``swap_dst``        two slots' destinations exchanged → ``EQ_TABLE_ROW``
``drop_inv``        a NOT slot's invert flag cleared → ``EQ_TABLE_ROW``
``reorder_level``   two dependent levels swapped → stale entry reads
``const_write``     a live slot retargeted at the constant-zero row →
                    ``RACE_CONST_WRITE`` (and clobbered-const dataflow)
``truncate_slot``   a live slot blanked to inert padding → its write
                    vanishes → ``EQ_TABLE_ROW``
``stale_pad``       one constant-one pad operand flipped to zero → the
                    pad pairs no longer cancel → ``EQ_TABLE_ROW``
==================  ====================================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.analyze.races import _is_inert_slot
from repro_torch.compile.megakernel import (MegaLowering, ONE_ROW,
                                            TRASH_ROW, ZERO_ROW)


def _copy(low: MegaLowering) -> MegaLowering:
    return dataclasses.replace(low, src=low.src.copy(), dst=low.dst.copy(),
                               inv=low.inv.copy())


def _live_slots(low: MegaLowering, reverse: bool = True
                ) -> Iterator[tuple[int, int]]:
    """(level, slot) pairs of non-inert slots, latest level first."""
    levels = range(low.n_levels - 1, -1, -1) if reverse \
        else range(low.n_levels)
    for li in levels:
        for w in range(low.w_max):
            if not _is_inert_slot(low.src[li, w], int(low.dst[li, w]),
                                  int(low.inv[li, w])):
                yield li, w


def _slot_sig(low: MegaLowering, li: int, w: int) -> tuple:
    return (tuple(int(r) for r in low.src[li, w]), int(low.inv[li, w]))


def swap_dst(low: MegaLowering) -> Optional[MegaLowering]:
    """Exchange the destination rows of two differing slots of one level."""
    by_level: dict[int, list[int]] = {}
    for li, w in _live_slots(low):
        by_level.setdefault(li, []).append(w)
    for li in sorted(by_level, reverse=True):
        slots = by_level[li]
        for a in slots:
            for b in slots:
                if (low.dst[li, a] != low.dst[li, b]
                        and _slot_sig(low, li, a) != _slot_sig(low, li, b)):
                    m = _copy(low)
                    m.dst[li, a], m.dst[li, b] = (low.dst[li, b],
                                                  low.dst[li, a])
                    return m
    return None


def drop_inv(low: MegaLowering) -> Optional[MegaLowering]:
    """Clear the invert flag of one NOT slot."""
    for li, w in _live_slots(low):
        if low.inv[li, w]:
            m = _copy(low)
            m.inv[li, w] = 0
            return m
    return None


def reorder_level(low: MegaLowering) -> Optional[MegaLowering]:
    """Swap two adjacent levels that carry a real dataflow dependency.

    Only dependent pairs qualify — swapping independent levels is
    legal, and a mutation the analyzer *should* accept is not a
    negative test.
    """
    for li in range(low.n_levels - 2, -1, -1):
        written = {int(low.dst[li, w]) for li_, w in _live_slots(low)
                   if li_ == li} - {TRASH_ROW}
        reads_next = {int(r) for li_, w in _live_slots(low) if li_ == li + 1
                      for r in low.src[li_, w]}
        if written & reads_next:
            m = _copy(low)
            for arr in (m.src, m.dst, m.inv):
                arr[[li, li + 1]] = arr[[li + 1, li]]
            meta = list(low.level_meta)
            meta[li], meta[li + 1] = meta[li + 1], meta[li]
            return dataclasses.replace(m, level_meta=tuple(meta))
    return None


def const_write(low: MegaLowering) -> Optional[MegaLowering]:
    """Retarget one live slot at the constant-zero row."""
    for li, w in _live_slots(low):
        m = _copy(low)
        m.dst[li, w] = ZERO_ROW
        return m
    return None


def truncate_slot(low: MegaLowering) -> Optional[MegaLowering]:
    """Blank one live slot to inert padding — its write silently vanishes."""
    for li, w in _live_slots(low):
        m = _copy(low)
        m.src[li, w] = ZERO_ROW
        m.dst[li, w] = TRASH_ROW
        m.inv[li, w] = 0
        return m
    return None


def stale_pad(low: MegaLowering) -> Optional[MegaLowering]:
    """Flip one constant-one pad operand to constant-zero.

    Breaks the ``MAJ_k == MAJ_{k+2m}`` padding identity: the popcount
    threshold no longer matches the added constants, so the slot votes
    a different function than its source op.  Real operand rows are
    shifted past the constant prefix, so any ``ONE_ROW`` operand in a
    live slot is padding by construction.
    """
    for li, w in _live_slots(low):
        ones = np.flatnonzero(low.src[li, w] == ONE_ROW)
        if ones.size:
            m = _copy(low)
            m.src[li, w, int(ones[-1])] = ZERO_ROW
            return m
    return None


#: Name -> mutation, in the order CI reports them.
MUTATIONS: dict[str, Callable[[MegaLowering], Optional[MegaLowering]]] = {
    "swap_dst": swap_dst,
    "drop_inv": drop_inv,
    "reorder_level": reorder_level,
    "const_write": const_write,
    "truncate_slot": truncate_slot,
    "stale_pad": stale_pad,
}


def apply_mutation(low: MegaLowering, name: str) -> Optional[MegaLowering]:
    """Apply one named mutation; None when the artifact has no site."""
    return MUTATIONS[name](low)
