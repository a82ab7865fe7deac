"""Calibrated empirical success-rate model for PUD operations.

The paper characterizes the *success rate* — the fraction of DRAM cells that
produce the correct result across all trials — of simultaneous many-row
activation (SiMRA), MAJX, and Multi-RowCopy under timing (t1, t2), data
pattern, temperature, and wordline voltage.  This module is a parametric
surface anchored **exactly** at every operating point the paper reports
(constants from :mod:`repro_torch.core.calibration`) and interpolated elsewhere
with documented model assumptions:

* SiMRA (Fig 3): plateau at >=3 ns; cliff when t2 < 3 ns (Obs 2), scaled by
  log2(N)/log2(8) around the paper's 8-row anchor.
* MAJX (Fig 6): optimum at (t1, t2) = (1.5, 3) ns; success decays as t1+t2
  grows (R_F over-shares, Obs 7 hypothesis 1) with the (3,3) point pinned
  45.50 % below optimum; t2 = 1.5 ns collapses the op (Obs 7 hypothesis 2).
* Replication (Obs 6/10): success interpolates log-linearly in N between the
  unreplicated minimum-N anchor and the 32-row anchor.
* Patterns (Obs 9/16), temperature (Obs 3/11/12/17), VPP (Obs 4/13/18):
  multiplicative adjustments pinned to the reported deltas.

The reference package also samples per-cell *stable masks* from these
surfaces; that sampling belongs with the behavioural simulator and is not
part of this module yet.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import calibration as cal

# ---------------------------------------------------------------------------
# timing surfaces
# ---------------------------------------------------------------------------


def _simra_timing_mult(n_act: int, t1: float, t2: float) -> float:
    """Multiplier vs the (3,3) ns optimum for N-row activation (Fig 3)."""
    if t2 >= 6.0:
        # fn 6: waiting >=6 ns between PRE and ACT degenerates to the
        # consecutive activation of two rows — many-row activation fails.
        return 0.0 if n_act > 2 else 1.0
    scale = math.log2(max(n_act, 2)) / math.log2(cal.SIMRA_OBS2_N)
    mult = 1.0
    if t1 < 3.0 and t2 < 3.0:
        # Obs 2 anchor: (1.5, 1.5) is 21.74 % below best for 8-row.
        mult *= 1.0 - cal.SIMRA_OBS2_DROP_REL * scale
    elif t2 < 3.0:
        # t2=1.5 with relaxed t1: intermediate-signal assertion marginal.
        mult *= 1.0 - 0.5 * cal.SIMRA_OBS2_DROP_REL * scale
    elif t1 < 3.0:
        # t1=1.5, t2=3: near-best (this is the MAJX optimum region).
        mult *= 0.999
    return max(mult, 0.0)


def _majx_timing_mult(t1: float, t2: float) -> float:
    """Multiplier vs the (1.5, 3) ns optimum (Fig 6, Obs 7)."""
    if t2 < 3.0:
        # Hypothesis 2: PRE->ACT too fast to assert intermediate decoder
        # signals; many-row activation mostly fails to engage.
        return 0.30
    if t2 >= 6.0:
        return 0.0  # degenerates to consecutive two-row activation
    # Hypothesis 1: larger t1+t2 lets R_F share disproportionate charge.
    # Pinned: (3,3) => 1/(1+0.4550).
    steps = ((t1 + t2) - (cal.MAJX_BEST_T1_NS + cal.MAJX_BEST_T2_NS)) / 1.5
    return 1.0 / (1.0 + cal.MAJ3_32_BEST_OVER_SECOND_REL * max(steps, 0.0))


def _mrc_timing_mult(n_dest: int, t1: float, t2: float) -> float:
    """Multiplier vs the (36, 3) ns optimum (Fig 10, Obs 14/15)."""
    if t2 >= 6.0 and n_dest > 1:
        # fn 6: consecutive 2-row activation — a plain RowClone; only one
        # destination receives data.
        return 1.0 / n_dest
    # Sense amps need ~tRAS to fully drive bitlines with the source charge.
    t1_curve = {36.0: 1.0, 9.0: 0.97, 6.0: 0.93, 3.0: 0.85}
    if t1 >= 36.0:
        base = 1.0
    elif t1 <= 1.5:
        # Obs 15: 49.79 % below the second-worst configuration (t1=3).
        base = t1_curve[3.0] * (1.0 - cal.MRC_T1_1P5_BELOW_SECOND_WORST_REL)
    else:
        keys = sorted(t1_curve)
        lo = max(k for k in keys if k <= t1)
        hi = min(k for k in keys if k >= t1)
        if lo == hi:
            base = t1_curve[lo]
        else:
            w = (t1 - lo) / (hi - lo)
            base = t1_curve[lo] * (1 - w) + t1_curve[hi] * w
    if t2 < 3.0:
        base *= 0.95
    return base


# ---------------------------------------------------------------------------
# replication interpolation
# ---------------------------------------------------------------------------


def _majx_replication_base(x: int, n_act: int) -> float:
    """Success at best timings / random pattern / 50C / 2.5V (Obs 6/8/10)."""
    n_min = cal.min_activation_for(x)
    if n_act < n_min:
        raise ValueError(f"MAJ{x} needs >= {n_min}-row activation")
    s_min = cal.majx_success_min_activation(x)
    s_max = cal.MAJX_SUCCESS_32ROW[x]
    if n_act >= 32:
        return s_max
    lo, hi = math.log2(n_min), math.log2(32)
    w = (math.log2(n_act) - lo) / (hi - lo)
    return s_min + (s_max - s_min) * w


# ---------------------------------------------------------------------------
# environment adjustments
# ---------------------------------------------------------------------------


def _temp_mult_majx(x: int, n_act: int, temp_c: float) -> float:
    """Obs 11/12: success *rises* with temperature; replication damps it."""
    n_min = cal.min_activation_for(x)
    r = n_act / n_min  # replication factor (1 .. 8)
    # Pinned: MAJ3@4 (r=1) max variation 15.20 %; MAJ3@32 (r=8) 1.65 %.
    lo_amp = cal.MAJ3_TEMP_VARIATION_4ROW_MAX_REL
    hi_amp = cal.MAJ3_TEMP_VARIATION_32ROW_MAX_REL
    expo = math.log(lo_amp / hi_amp) / math.log(8.0)
    amp = lo_amp / (r ** expo)
    return 1.0 + amp * (temp_c - 50.0) / 40.0


def _vpp_mult(kind: str, vpp_v: float) -> float:
    drop = {
        "simra": cal.SIMRA_VPP_DROP_REL_MAX,
        "majx": cal.MAJX_VPP_VARIATION_AVG_REL,
        "mrc": cal.MRC_VPP_DROP_REL_MAX,
    }[kind]
    return 1.0 - drop * (2.5 - vpp_v) / 0.4


def _pattern_mult_majx(x: int, pattern: str) -> float:
    """Obs 9: anchors are the *random* pattern (worst case)."""
    if pattern == "random":
        return 1.0
    if pattern not in cal.DATA_PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}")
    # Fixed patterns have "a small and similar effect"; 0x00/0xFF pinned.
    fixed_gain = 1.0 / (1.0 - cal.MAJX_RANDOM_BELOW_FIXED_REL[x])
    jitter = {"0x00/0xFF": 1.0, "0xAA/0x55": 0.999, "0xCC/0x33": 0.998,
              "0x66/0x99": 0.9985}[pattern]
    return fixed_gain * jitter


def _pattern_mult_mrc(n_dest: int, pattern: str) -> float:
    """Obs 16: all-1s to 31 rows is 0.79 % lower; otherwise <= 0.11 %."""
    if pattern in ("random", "0x00"):
        return 1.0
    if pattern in ("0xFF", "all1"):
        if n_dest >= 31:
            return 1.0 - cal.MRC_ALL1_31_DROP_REL
        return 1.0 - cal.MRC_PATTERN_MAX_REL_LE15
    return 1.0 - 0.0005


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ErrorModel:
    """Success-rate surfaces for one manufacturer profile."""

    mfr: str = "H"

    @property
    def anchor(self) -> cal.DeviceAnchor:
        return cal.DEVICE_ANCHORS[self.mfr]

    # -- SiMRA -------------------------------------------------------------
    def simra_success(
        self, n_act: int, t1: float = cal.SIMRA_BEST_T1_NS,
        t2: float = cal.SIMRA_BEST_T2_NS, temp_c: float = 50.0,
        vpp_v: float = 2.5,
    ) -> float:
        if not self.anchor.supports_simra:
            return 0.0  # §9 Limitation 1 (Samsung)
        if n_act not in cal.SIMRA_SUCCESS_BEST:
            raise ValueError(f"N={n_act} not reachable (Limitation 2)")
        s = cal.SIMRA_SUCCESS_BEST[n_act]
        s *= _simra_timing_mult(n_act, t1, t2)
        # Obs 3: -0.07 % from 50C to 90C.
        s *= 1.0 - cal.SIMRA_TEMP_DROP_REL_50_TO_90 * (temp_c - 50.0) / 40.0
        s *= _vpp_mult("simra", vpp_v)
        return float(min(max(s, 0.0), 1.0))

    # -- MAJX --------------------------------------------------------------
    def majx_success(
        self, x: int, n_act: int, t1: float = cal.MAJX_BEST_T1_NS,
        t2: float = cal.MAJX_BEST_T2_NS, pattern: str = "random",
        temp_c: float = 50.0, vpp_v: float = 2.5,
    ) -> float:
        if not self.anchor.supports_simra:
            return 0.0
        if x % 2 == 0 or x < 3:
            raise ValueError("MAJX requires odd X >= 3")
        if x > self.anchor.max_majx:
            return 0.005  # fn 11: <1 % success; omitted by the paper
        s = _majx_replication_base(x, n_act)
        s *= _majx_timing_mult(t1, t2)
        s *= _pattern_mult_majx(x, pattern)
        s *= _temp_mult_majx(x, n_act, temp_c)
        s *= _vpp_mult("majx", vpp_v)
        return float(min(max(s, 0.0), 1.0))

    # -- Multi-RowCopy -------------------------------------------------------
    def mrc_success(
        self, n_dest: int, t1: float = cal.MRC_BEST_T1_NS,
        t2: float = cal.MRC_BEST_T2_NS, pattern: str = "random",
        temp_c: float = 50.0, vpp_v: float = 2.5,
    ) -> float:
        if not self.anchor.supports_simra:
            if n_dest == 1 and t2 >= 6.0:
                return 0.99996  # plain RowClone still works everywhere
            return 0.0
        levels = sorted(cal.MRC_SUCCESS_BEST)
        if n_dest not in cal.MRC_SUCCESS_BEST:
            n_key = min((k for k in levels if k >= n_dest), default=31)
        else:
            n_key = n_dest
        s = cal.MRC_SUCCESS_BEST[n_key]
        s *= _mrc_timing_mult(n_dest, t1, t2)
        s *= _pattern_mult_mrc(n_dest, pattern)
        # Obs 17: tiny, direction as SiMRA (peripheral circuitry).
        s *= 1.0 - cal.MRC_TEMP_VARIATION_AVG_REL * (temp_c - 50.0) / 40.0
        s *= _vpp_mult("mrc", vpp_v)
        return float(min(max(s, 0.0), 1.0))


def expected_retries(success: float, floor: float = 1e-3) -> float:
    """Expected repetitions until a row-group op fully succeeds (§8.1).

    The case studies pick the best row groups and re-execute failed ops;
    1/success is the geometric-retry estimate used by the throughput model.
    """
    return 1.0 / max(success, floor)
