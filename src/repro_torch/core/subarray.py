"""Behavioural DRAM-subarray simulator executing command sequences.

State per subarray: packed bit-planes (one row of the plane matrix per DRAM
row), a per-row Frac flag (row charged to VDD/2 — contributes capacitance
but no differential charge, §2.2/§3.3), the sense-amp row buffer, and the
set of currently-open (asserted) wordlines.

The simulator implements the paper's three operating regimes for the APA
sequence, selected by the issued timings exactly as on real chips:

* ``t1 < tRAS`` and ``t2 < 6 ns`` → **charge-share regime** (§3.3): all
  simultaneously activated, non-neutral cells majority-vote per bitline.
* ``t1 >= tRAS`` and ``t2 < 6 ns`` → **Multi-RowCopy regime** (§3.4): the
  sense amps latch R_F then overwrite every activated row.
* ``t2 >= 6 ns`` → **consecutive activation** (fn 6): a plain RowClone
  from R_F to R_S.

Per-cell correctness is drawn from the calibrated
:class:`~repro_torch.core.errormodel.ErrorModel` via deterministic
stable-cell masks, so repeated trials reproduce the same unstable cells
(the paper's success-rate metric).

The planes are a ``(rows, n_words)`` int32 tensor on ``device`` (the
card unless the caller names another), updated in place; every row read
out of them is a copy.  The masks are drawn with
:mod:`repro_torch.core.rng`, word for word with the reference's
``jax.random`` draws, on the same device.  ``_stable_mask`` folds
``hash(s) & 0x7FFFFFFF`` of its salts into the key as the reference
does; Python salts ``str`` hashes per process, so a stochastic run
repeats the reference's masks only within one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.core import commands as cmd
from repro_torch.core import rng
from repro_torch.core.decoder import RowDecoder
from repro_torch.core.errormodel import ErrorModel

#: The §3.1 fixed data patterns, by the byte each word repeats.
_PATTERN_BYTES = {"0x00": 0x00, "0xFF": 0xFF, "0xAA": 0xAA, "0x55": 0x55,
                  "0xCC": 0xCC, "0x33": 0x33, "0x66": 0x66, "0x99": 0x99}


def _odd_at_most(n: int) -> int:
    """Largest odd integer <= n (raw-APA operand-count estimate)."""
    return n if n % 2 == 1 else n - 1


@dataclasses.dataclass
class DeviceProfile:
    """Per-manufacturer behaviour (§3.1 Table 1, §9 Limitation 1)."""

    mfr: str = "H"
    subarray_rows: int = 512
    #: sense-amp tie polarity (§3.3 fn 5: Mfr M amps bias to a fixed value)
    tie_bias: int = 0

    @property
    def anchor(self) -> cal.DeviceAnchor:
        return cal.DEVICE_ANCHORS[self.mfr]

    @classmethod
    def mfr_h(cls) -> "DeviceProfile":
        return cls(mfr="H", subarray_rows=512, tie_bias=0)

    @classmethod
    def mfr_m(cls) -> "DeviceProfile":
        return cls(mfr="M", subarray_rows=1024, tie_bias=0)

    @classmethod
    def mfr_s(cls) -> "DeviceProfile":
        return cls(mfr="S", subarray_rows=512, tie_bias=0)


class Subarray:
    """One DRAM subarray with ``rows`` rows of ``cols`` cells."""

    def __init__(
        self,
        profile: DeviceProfile = None,
        cols: int = 1024,
        *,
        temp_c: float = 50.0,
        vpp_v: float = 2.5,
        seed: int = 0,
        ideal: bool = False,
        device="cuda",
    ):
        self.profile = profile or DeviceProfile.mfr_h()
        self.rows = self.profile.subarray_rows
        self.cols = cols
        self.n_words = bp.n_words(cols)
        self.temp_c = temp_c
        self.vpp_v = vpp_v
        #: ``ideal=True`` disables the stochastic error model (unit tests of
        #: pure PUD semantics; equivalent to success rate 1.0 everywhere).
        self.ideal = ideal
        self.device = torch.device(device)
        self.decoder = RowDecoder.for_subarray(self.rows)
        self.errors = ErrorModel(self.profile.mfr)
        self._key = rng.PRNGKey(seed)
        self.planes = torch.zeros((self.rows, self.n_words), dtype=torch.int32,
                                  device=self.device)
        self.frac_rows = np.zeros((self.rows,), bool)
        self.row_buffer = torch.zeros((self.n_words,), dtype=torch.int32,
                                      device=self.device)
        self.buffer_valid = False
        self.open_rows: tuple[int, ...] = ()
        #: cumulative issued-command time (ns), for latency accounting
        self.elapsed_ns = 0.0

    # ------------------------------------------------------------------ I/O
    def _words(self, data) -> torch.Tensor:
        """One row image as int32 words on this subarray's device."""
        if isinstance(data, torch.Tensor):
            if data.dtype != torch.int32:
                raise TypeError(f"packed words are int32 tensors, got "
                                f"{data.dtype}")
            words = data.to(self.device)
        else:
            words = bp.from_u32(data, self.device)
        return words.reshape(self.n_words)

    def write_row(self, row: int, data) -> None:
        self.planes[row] = self._words(data)
        self.frac_rows[row] = False

    def write_row_bits(self, row: int, bits) -> None:
        self.write_row(row, bp.pack(torch.as_tensor(bits)))

    def read_row(self, row: int) -> torch.Tensor:
        return self.planes[row].clone()

    def read_row_bits(self, row: int) -> torch.Tensor:
        return bp.unpack(self.planes[row], self.cols)

    def fill(self, pattern: str, *, key: Optional[torch.Tensor] = None) -> None:
        """Initialize the whole subarray with a §3.1 data pattern.

        ``"random"`` draws uniform 32-bit words, as
        ``jax.random.bits(key, shape, jnp.uint32)`` does; the reference's
        own call (``randint`` over uint32 up to ``1 << 32``) raises
        ``OverflowError`` under jax 0.9.0.
        """
        if pattern == "random":
            key = key if key is not None else self._next_key()
            self.planes = rng.random_bits(key, (self.rows, self.n_words),
                                          self.device)
        else:
            word = np.uint32(_PATTERN_BYTES[pattern] * 0x01010101)
            self.planes = torch.full((self.rows, self.n_words),
                                     int(word.view(np.int32)),
                                     dtype=torch.int32, device=self.device)
        self.frac_rows[:] = False

    # ------------------------------------------------------------ execution
    def run(self, seq: cmd.CommandSeq) -> None:
        """Execute a command sequence with timing-dependent semantics."""
        cmds = list(seq)
        self.elapsed_ns += seq.duration_ns
        i = 0
        while i < len(cmds):
            c = cmds[i]
            if c.kind == "ACT":
                # Look ahead for the APA idiom: ACT -> PRE -> ACT.
                if (
                    i + 2 < len(cmds)
                    and cmds[i + 1].kind == "PRE"
                    and cmds[i + 2].kind == "ACT"
                    and cmds[i + 1].gap_ns < 6.0
                ):
                    self._apa(c.row, cmds[i + 2].row, c.gap_ns, cmds[i + 1].gap_ns)
                    i += 3
                    continue
                if (
                    i + 2 < len(cmds)
                    and cmds[i + 1].kind == "PRE"
                    and cmds[i + 2].kind == "ACT"
                    and cmds[i + 1].gap_ns < cmd.NOMINAL.trp
                ):
                    # consecutive activation (fn 6): RowClone
                    self._rowclone(c.row, cmds[i + 2].row)
                    i += 3
                    continue
                if c.gap_ns < 12.0 and not self.frac_rows[c.row]:
                    # interrupted restore: Frac initialization (§2.2)
                    self._frac(c.row)
                    i += 1
                    continue
                self._activate(c.row)
            elif c.kind == "PRE":
                self._precharge()
            elif c.kind == "WR":
                self._write_through(c.data)
            elif c.kind == "RD":
                self._activate(c.row)
            i += 1

    # ------------------------------------------------------------ regimes
    def _activate(self, row: int) -> None:
        self.row_buffer = self.planes[row].clone()
        self.buffer_valid = True
        self.open_rows = (row,)

    def _precharge(self) -> None:
        self.buffer_valid = False
        self.open_rows = ()

    def _frac(self, row: int) -> None:
        if not self.profile.anchor.supports_frac:
            # §3.3 fn 5: Mfr M emulates neutral rows with the sense-amp bias
            # polarity; we model that as an all-<bias> row marked neutral.
            if not self.profile.anchor.frac_via_bias:
                raise RuntimeError(f"Mfr {self.profile.mfr}: no Frac, no bias")
        self.frac_rows[row] = True
        self.open_rows = ()
        self.buffer_valid = False

    def _rowclone(self, src: int, dst: int) -> None:
        s = self.errors.mrc_success(1, t1=cmd.NOMINAL.tras, t2=6.0,
                                    temp_c=self.temp_c, vpp_v=self.vpp_v)
        self._overwrite_rows((dst,), self.planes[src].clone(), s,
                             op="rowclone")
        self.row_buffer = self.planes[src].clone()
        self.buffer_valid = True
        self.open_rows = (src, dst)

    def _apa(self, rf: int, rs: int, t1: float, t2: float) -> None:
        if not self.profile.anchor.supports_simra:
            # §9 Limitation 1: chip ignores the violated-timing sequence and
            # behaves like a normal activation of the second row.
            self._activate(rs)
            return
        act = self.decoder.apa_activated_rows(rf, rs)
        self.open_rows = act
        if t1 >= cmd.NOMINAL.tras:
            self._apa_mrc(rf, act, t1, t2)
        else:
            self._apa_chargeshare(rf, rs, act, t1, t2)

    def _apa_mrc(self, rf: int, act: Sequence[int], t1: float, t2: float) -> None:
        """Multi-RowCopy regime: sense amps hold R_F; destinations overwritten."""
        dests = tuple(r for r in act if r != rf)
        s = self.errors.mrc_success(len(dests), t1=t1, t2=t2,
                                    temp_c=self.temp_c, vpp_v=self.vpp_v)
        src = self.planes[rf].clone()
        self._overwrite_rows(dests, src, s, op=f"mrc{len(dests)}")
        self.row_buffer = src
        self.buffer_valid = True

    def _apa_chargeshare(
        self, rf: int, rs: int, act: Sequence[int], t1: float, t2: float
    ) -> None:
        """Charge-share regime: per-bitline majority over non-neutral rows."""
        contributing = [r for r in act if not self.frac_rows[r]]
        n_act = len(act)
        if not contributing:
            return
        stack = self.planes[torch.tensor(contributing, device=self.device)]
        if len(contributing) % 2 == 1:
            result = bp.majority_words(stack, axis=0)
        else:
            result = bp.majority_with_ties(stack, self.profile.tie_bias, axis=0)
        # Success rate: the op-level wrappers (repro_torch.core.majx) pass
        # the operand multiplicity; raw APA assumes unreplicated inputs.
        x = self._x_hint if self._x_hint else _odd_at_most(len(contributing))
        self._x_hint = 0
        s = self.errors.majx_success(
            x, n_act, t1=t1, t2=t2, pattern=self._pattern_hint,
            temp_c=self.temp_c, vpp_v=self.vpp_v,
        ) if x >= 3 else self.errors.simra_success(
            n_act, t1=t1, t2=t2, temp_c=self.temp_c, vpp_v=self.vpp_v)
        # Unstable cells resolve to the complement (sense amp flips).
        if not self.ideal and s < 1.0:
            mask = self._stable_mask((self.n_words,), s, ("apa", rf, rs))
            result = (result & mask) | (~result & ~mask)
        self._overwrite_rows(tuple(act), result, 1.0, op="chargeshare",
                             skip_mask=False)
        self.row_buffer = result
        self.buffer_valid = True

    _x_hint: int = 0
    _pattern_hint: str = "random"

    def hint(self, x: int = 0, pattern: str = "random") -> None:
        """Operand-count / pattern hint for the next charge-share APA.

        The physical op doesn't know how many *distinct* operands the rows
        hold; the MAJX wrapper passes it so the calibrated surface applies.
        """
        self._x_hint = x
        self._pattern_hint = pattern

    def _write_through(self, data: np.ndarray) -> None:
        """WR while rows are open: overdrives bitlines, updating every open
        row (§3.2 SiMRA test methodology)."""
        if not self.open_rows:
            return
        data = self._words(data)
        n_act = len(self.open_rows)
        if n_act in cal.SIMRA_SUCCESS_BEST:
            s = self.errors.simra_success(n_act, temp_c=self.temp_c,
                                          vpp_v=self.vpp_v)
        else:
            s = 1.0
        self._overwrite_rows(self.open_rows, data, s, op="wr")
        self.row_buffer = data.clone()

    # ------------------------------------------------------------ helpers
    def _overwrite_rows(self, rows, data, success, op, skip_mask=True) -> None:
        if not rows:
            return
        rows_arr = torch.tensor(rows, device=self.device)
        if self.ideal or success >= 1.0:
            new = data.expand(len(rows), self.n_words)
        else:
            mask = self._stable_mask((len(rows), self.n_words * 32), success,
                                     (op, rows[0]))
            mask = bp.pack(mask)
            old = self.planes[rows_arr]
            new = (data[None, :] & mask) | (old & ~mask)
        self.planes[rows_arr] = new
        for r in rows:
            self.frac_rows[r] = False

    def _stable_mask(self, shape, success, salt) -> torch.Tensor:
        if self.ideal:
            return torch.ones(shape, dtype=torch.bool, device=self.device)
        key = self._key
        for s in salt:
            key = rng.fold_in(key, hash(s) & 0x7FFFFFFF)
        if len(shape) == 1 and shape[-1] == self.n_words:
            bits = self.errors.stable_mask(key, (self.n_words * 32,), success,
                                           self.device)
            return bp.pack(bits)
        return self.errors.stable_mask(key, shape, success, self.device)

    def _next_key(self) -> torch.Tensor:
        self._key, sub = rng.split(self._key)
        return sub
