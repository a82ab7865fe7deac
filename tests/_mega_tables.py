"""Hand-made megakernel level tables that hit each rule of the
execution plan (``kernels/megakernel/plan.py``): trash-row reads,
constant pairs, padding levels, hazards, constant-row writes, two
writers of one row, even arities.  No JAX import, so the CPU plan tests
and the card's tests share them.
"""

import numpy as np

from repro_torch.compile.megakernel import (MegaLowering, ONE_ROW,
                                            TRASH_ROW, ZERO_ROW)


def low(levels, n_rows):
    """A MegaLowering from ``[(src rows, dst, inv), ...]`` per level (all
    of one arity), padded with inert slots: ZERO_ROW operands, TRASH_ROW
    destination."""
    w = max(len(lv) for lv in levels)
    x = len(levels[0][0][0])
    src = np.full((len(levels), w, x), ZERO_ROW, np.int32)
    dst = np.full((len(levels), w), TRASH_ROW, np.int32)
    inv = np.zeros((len(levels), w), np.uint32)
    for li, lv in enumerate(levels):
        for si, (s, d, f) in enumerate(lv):
            assert len(s) == x
            src[li, si] = s
            dst[li, si] = d
            inv[li, si] = f
    meta = tuple((len(lv), 0, 0, 0) for lv in levels)
    return MegaLowering(src=src, dst=dst, inv=inv, n_rows=n_rows,
                        level_meta=meta)


R = 3       # first program row in the augmented image
Z, O = ZERO_ROW, ONE_ROW

HAND = {
    # An inert-looking slot writes ONES into the trash row; the next
    # level reads it, a level of padding zeroes it, and a later level
    # reads it again: every trash writer must be kept.
    "trash_read_after_padded_level": low(
        [[((R + 1, R + 2, R + 3), R, 0), ((Z, Z, Z), TRASH_ROW, 1)],
         [((TRASH_ROW, R, R + 1), R + 4, 0)],
         [],
         [((TRASH_ROW, R + 4, R + 1), R + 5, 0)]], 6),
    # Unpaired constants stay, matched (0, 1) pairs go.
    "unpaired_constants": low(
        [[((R, Z, Z, Z, Z), R + 1, 0),
          ((R, Z, Z, O, R + 4), R + 2, 0),
          ((R, O, O, O, Z), R + 3, 1),
          ((Z, O, Z, O, R), R + 5, 0)]], 6),
    # A level of padding only, between two real levels.
    "all_padding_level": low(
        [[((R, R + 1, R + 2), R + 3, 0)],
         [],
         [((R + 3, O, Z), R + 4, 1)]], 6),
    # A swap inside one level: both slots are hazard slots.
    "swap_in_one_level": low(
        [[((R,), R + 1, 0), ((R + 1,), R, 0), ((R + 2,), R + 3, 1)]], 5),
    # A rotation of three rows, and a slot that reads its own
    # destination (not a hazard by itself).
    "rotation_and_self_read": low(
        [[((R + 1, Z, O), R, 0), ((R + 2, Z, O), R + 1, 0),
          ((R, Z, O), R + 2, 1), ((R + 3, R + 4, R + 5), R + 3, 0)]], 6),
    # A slot writes ones into the zero row; a later (0, 1) pair is then
    # no constant pair and must be kept.
    "constant_row_written": low(
        [[((O, O, O), Z, 0)],
         [((R, Z, O), R + 1, 0)]], 3),
    # Two slots of one level write the same row: the last one's vote
    # stands, and the slot that reads that row makes it a hazard.
    "two_writers_one_level": low(
        [[((R, R + 1, R + 2), R + 3, 0), ((R + 1, Z, O), R + 3, 1),
          ((R + 3, Z, O), R + 4, 0)]], 5),
    # An even arity: strict majority, 2 of 4 is not enough.
    "even_arity": low(
        [[((R, R + 1, R + 2, R + 3), R + 4, 0),
          ((R, R + 1, Z, O), R + 5, 0)]], 6),
}
