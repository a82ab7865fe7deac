"""Hierarchical row-decoder model (paper §7.1).

The paper hypothesises that simultaneous many-row activation arises from the
two-stage local wordline decoder: Stage 1 predecodes the 9-bit in-subarray
row address across five predecoder tiers (A..E) whose outputs are *latched*;
an APA sequence with violated tRP latches the second address *without
de-asserting* the first, so each predecoder may hold up to two one-hot
outputs.  Stage 2 asserts every local wordline whose predecoded address is
covered by the latched sets — the activated set is the Cartesian product of
the per-predecoder latched codes, giving 2^k rows where k is the number of
predecoders on which the two addresses differ (Limitation 2: only
2/4/8/16/32 are reachable).

Worked example from Fig. 14: APA(0, 7) with bit groups A=RA[0], B=RA[1:3]
latches {PA0,PA1} x {PB0,PB3} -> rows {0,1,6,7}.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import calibration as cal


@dataclasses.dataclass(frozen=True)
class PredecoderSpec:
    """One predecoder tier: a contiguous slice of row-address bits."""

    name: str
    lo: int  # inclusive bit index (LSB-first)
    hi: int  # exclusive

    @property
    def width(self) -> int:
        return self.hi - self.lo

    def code(self, row: int) -> int:
        return (row >> self.lo) & ((1 << self.width) - 1)


def default_predecoders(row_bits: int) -> tuple[PredecoderSpec, ...]:
    """The paper's 5-tier split.

    For 2^9-row subarrays (SK Hynix, §7.1): A=1 bit, B..E=2 bits each.
    For 2^10-row subarrays (Micron): A..E=2 bits each.
    Both give 5 predecoders -> up to 2^5 = 32 simultaneous rows.
    """
    if row_bits == 9:
        widths = (1, 2, 2, 2, 2)
    elif row_bits == 10:
        widths = (2, 2, 2, 2, 2)
    else:
        # Generic: distribute bits over 5 tiers, wider tiers last.
        base, extra = divmod(row_bits, cal.DECODER_NUM_PREDECODERS)
        widths = tuple(
            base + (1 if i >= cal.DECODER_NUM_PREDECODERS - extra else 0)
            for i in range(cal.DECODER_NUM_PREDECODERS)
        )
    specs = []
    lo = 0
    for name, w in zip("ABCDE", widths):
        specs.append(PredecoderSpec(name, lo, lo + w))
        lo += w
    assert lo == row_bits
    return tuple(specs)


@dataclasses.dataclass
class RowDecoder:
    """Behavioural model of the latching local wordline decoder."""

    n_rows: int
    predecoders: tuple[PredecoderSpec, ...]

    @classmethod
    def for_subarray(cls, n_rows: int) -> "RowDecoder":
        row_bits = max(1, (n_rows - 1).bit_length())
        return cls(n_rows=n_rows, predecoders=default_predecoders(row_bits))

    # -- single activation ------------------------------------------------
    def decode(self, row: int) -> tuple[int, ...]:
        """Standard ACT: one wordline."""
        self._check(row)
        return (row,)

    # -- APA with violated timings ----------------------------------------
    def apa_activated_rows(self, row_first: int, row_second: int) -> tuple[int, ...]:
        """Rows asserted by ACT(rf) -> PRE -> ACT(rs) with violated tRAS/tRP.

        Each predecoder latches {code(rf), code(rs)}; the asserted wordline
        set is the Cartesian product of the latched codes.
        """
        self._check(row_first)
        self._check(row_second)
        latched: list[tuple[int, ...]] = []
        for p in self.predecoders:
            codes = {p.code(row_first), p.code(row_second)}
            latched.append(tuple(sorted(codes)))
        rows = []
        for combo in itertools.product(*latched):
            row = 0
            for p, code in zip(self.predecoders, combo):
                row |= code << p.lo
            if row < self.n_rows:
                rows.append(row)
        return tuple(sorted(rows))

    def n_activated(self, row_first: int, row_second: int) -> int:
        return len(self.apa_activated_rows(row_first, row_second))

    def split_predecoders(self, row_first: int, row_second: int) -> int:
        """Number of predecoders on which the two addresses differ."""
        return sum(
            1
            for p in self.predecoders
            if p.code(row_first) != p.code(row_second)
        )

    # -- inverse problem: find an APA pair for a target set ---------------
    def pair_for_n_rows(self, n: int, base_row: int = 0) -> tuple[int, int]:
        """An (rf, rs) pair that simultaneously activates exactly ``n`` rows.

        ``n`` must be a power of two <= 2^(#predecoders) (Limitation 2).
        The returned pair differs on the log2(n) *widest-spread* predecoders
        so that all activated rows stay within the subarray.
        """
        k = n.bit_length() - 1
        if n != 1 << k or k > len(self.predecoders):
            raise ValueError(
                f"cannot activate {n} rows: only powers of two up to "
                f"2^{len(self.predecoders)} are reachable (Limitation 2)"
            )
        self._check(base_row)
        rs = base_row
        for p in self.predecoders[:k]:
            # Flip the low bit of this predecoder's field.
            rs ^= 1 << p.lo
        if rs >= self.n_rows:
            raise ValueError(f"row {rs} out of range for base {base_row}")
        return base_row, rs

    def row_group(self, n: int, base_row: int = 0) -> tuple[int, ...]:
        rf, rs = self.pair_for_n_rows(n, base_row)
        return self.apa_activated_rows(rf, rs)

    def _check(self, row: int) -> None:
        if not 0 <= row < self.n_rows:
            raise ValueError(f"row {row} out of range [0, {self.n_rows})")


def fig14_example() -> tuple[int, ...]:
    """The paper's walk-through: APA(0, 7) on a 512-row subarray -> {0,1,6,7}."""
    return RowDecoder.for_subarray(512).apa_activated_rows(0, 7)


def fig13_32row_example() -> tuple[int, ...]:
    """§7.1: ACT 127 -> PRE -> ACT 128 splits all five predecoders -> 32 rows."""
    return RowDecoder.for_subarray(512).apa_activated_rows(127, 128)
