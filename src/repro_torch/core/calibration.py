"""Calibration anchors: every quantitative claim of the SiMRA-DRAM paper.

This module is the single source of truth for the numbers printed in
"Simultaneous Many-Row Activation in Off-the-Shelf DRAM Chips: Experimental
Characterization and Analysis" (DSN 2024).  The behavioural error model
(`repro_torch.core.errormodel`), the charge-sharing Monte-Carlo
(`repro_torch.core.chargeshare`), the latency/power models (`repro_torch.pud.latency`,
`repro_torch.core.power`) and the §8 case-study benchmarks are all calibrated
against the constants below, and `tests/test_calibration.py` pins them.

Percentages follow the paper's own relative-percentage convention
(e.g. "MAJ3 with 32-row activation has a 30.81% *higher* success rate than
MAJ3 with 4-row activation" means ``s32 == s4 * 1.3081``), which is the only
reading consistent across Obs 6-10 (absolute-point readings would exceed
100% or go negative for MAJ7/MAJ9).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

# ---------------------------------------------------------------------------
# §3 Methodology constants
# ---------------------------------------------------------------------------

#: Timing grid used throughout the paper (DRAM Bender slot granularity 1.5ns).
T_GRID_NS = (1.5, 3.0, 6.0, 9.0, 36.0)

#: Number of simultaneously activated rows observed (§4, Limitation 2).
N_ACT_LEVELS = (2, 4, 8, 16, 32)

#: Temperatures tested (deg C); experiments default to 50C.
TEMPERATURES_C = (50.0, 60.0, 70.0, 80.0, 90.0)

#: Wordline voltages tested (V); nominal VPP = 2.5V.
VPP_LEVELS_V = (2.5, 2.4, 2.3, 2.2, 2.1)

#: Data patterns tested (§3.1).  "random" is the worst-case default.
DATA_PATTERNS = ("random", "0x00/0xFF", "0xAA/0x55", "0xCC/0x33", "0x66/0x99")

#: Tested chips (Table 1): (mfr, die_rev) -> (modules, chips, density, org, subarray_size)
TABLE1 = {
    ("H", "M"): dict(modules=7, chips=56, density="4Gb", org="x8", subarray_sizes=(512, 640)),
    ("H", "A"): dict(modules=5, chips=40, density="4Gb", org="x8", subarray_sizes=(512,)),
    ("M", "E"): dict(modules=4, chips=16, density="16Gb", org="x16", subarray_sizes=(1024,)),
    ("M", "B"): dict(modules=2, chips=8, density="16Gb", org="x16", subarray_sizes=(1024,)),
}

# ---------------------------------------------------------------------------
# §4 Simultaneous many-row activation
# ---------------------------------------------------------------------------

#: Obs 1: success of N-row activation at the best timings (t1=3ns, t2=3ns).
SIMRA_SUCCESS_BEST: Mapping[int, float] = {
    2: 0.9999, 4: 0.9999, 8: 0.9999, 16: 0.9999, 32: 0.9985,
}
SIMRA_BEST_T1_NS = 3.0
SIMRA_BEST_T2_NS = 3.0

#: Obs 2: 8-row activation at t1=t2=1.5ns is 21.74% (relative) below the best
#: timing for 8-row activation (t1=1.5, t2=3.0).
SIMRA_OBS2_DROP_REL = 0.2174
SIMRA_OBS2_N = 8

#: Obs 3: 50C -> 90C decreases SiMRA success by 0.07% on average (relative).
SIMRA_TEMP_DROP_REL_50_TO_90 = 0.0007

#: Obs 4: VPP 2.5V -> 2.1V decreases SiMRA success by at most 0.41% (relative).
SIMRA_VPP_DROP_REL_MAX = 0.0041

#: Obs 5: 32-row activation power is 21.19% below REF (the most
#: power-hungry standard op).
SIMRA32_POWER_VS_REF = -0.2119

# ---------------------------------------------------------------------------
# §5 MAJX
# ---------------------------------------------------------------------------

#: Obs 8: average success at 32-row activation, random data, best timings.
MAJX_SUCCESS_32ROW: Mapping[int, float] = {
    3: 0.9900, 5: 0.7964, 7: 0.3387, 9: 0.0591,
}

#: Best timings for MAJX (Obs 7): t1=1.5ns, t2=3.0ns.
MAJX_BEST_T1_NS = 1.5
MAJX_BEST_T2_NS = 3.0

#: Obs 7: best timing is 45.50% (relative) above the second best (t1=t2=3ns)
#: for MAJ3 with 32-row activation.
MAJ3_32_BEST_OVER_SECOND_REL = 0.4550

#: Obs 6: MAJ3@32-row is 30.81% (relative) above MAJ3@4-row.
MAJ3_REPLICATION_GAIN_32_OVER_4_REL = 0.3081

#: Obs 10: input replication gain (relative), 32-row vs the minimum
#: activation count that fits X operands with no replication.
MAJX_REPLICATION_GAIN_REL: Mapping[int, float] = {
    5: 0.5627, 7: 0.3515, 9: 0.1311,
}

#: Obs 9: random pattern is x% (relative) below 0x00/0xFF at 32-row act.
MAJX_RANDOM_BELOW_FIXED_REL: Mapping[int, float] = {
    3: 0.0068, 5: 0.1385, 7: 0.3256, 9: 0.1651,
}

#: §1/§Abstract: data pattern affects MAJX success by 11.52% on average.
MAJX_PATTERN_EFFECT_AVG_REL = 0.1152

#: Obs 11: 50C->90C varies MAJX success by 4.25% on average (higher T helps).
MAJX_TEMP_VARIATION_AVG_REL = 0.0425

#: Obs 12: max temperature-induced variation, MAJ3.
MAJ3_TEMP_VARIATION_32ROW_MAX_REL = 0.0165
MAJ3_TEMP_VARIATION_4ROW_MAX_REL = 0.1520

#: Obs 13: VPP scaling varies MAJX success by 1.10% on average.
MAJX_VPP_VARIATION_AVG_REL = 0.0110

#: Footnote 11: omitted ops with <1% success: MAJ11+ (Mfr H), MAJ9+ (Mfr M).
MAJX_MAX_X = {"H": 9, "M": 7}

#: §8.1: the case studies "choose the group of rows ... which produces the
#: highest throughput" — i.e. the best-performing row groups, not the
#: average.  Fig. 7's box whiskers reach ~100 % for MAJ5/MAJ7; the values
#: below are derived so the Fig. 16 speedup *ordering and signs* reproduce
#: (MAJ9 on Mfr H stays poor enough to degrade performance, Obs: -114.12 %).
MAJX_BEST_GROUP_SUCCESS = {
    "H": {3: 0.999, 5: 0.990, 7: 0.975, 9: 0.150},
    "M": {3: 0.999, 5: 0.995, 7: 0.990},
}
#: Best-group MAJ3 success at 4-row activation (the §8.1 baseline).
#: Per manufacturer: Mfr M has no Frac support, so its 4-row baseline's
#: neutral row relies on the weaker sense-amp-bias emulation (§3.3 fn 5) —
#: which is why Fig 16's speedups from the new MAJX ops are much larger on
#: Mfr M (+121.61 %) than on Mfr H (+46.54 %).
MAJ3_4ROW_BEST_GROUP_SUCCESS = {"H": 0.950, "M": 0.720}

# ---------------------------------------------------------------------------
# §6 Multi-RowCopy
# ---------------------------------------------------------------------------

#: Obs 14: success per destination count at best timings (t1=36ns, t2=3ns).
MRC_SUCCESS_BEST: Mapping[int, float] = {
    1: 0.99996, 3: 0.99989, 7: 0.99998, 15: 0.99999, 31: 0.99982,
}
MRC_BEST_T1_NS = 36.0
MRC_BEST_T2_NS = 3.0

#: Obs 15: t1=1.5ns is 49.79% (relative) below the second-worst timing config.
MRC_T1_1P5_BELOW_SECOND_WORST_REL = 0.4979

#: Obs 16: copying all-1s to 31 rows is 0.79% (relative) below all-0s/random;
#: for <=15 destinations pattern differences are at most 0.11%.
MRC_ALL1_31_DROP_REL = 0.0079
MRC_PATTERN_MAX_REL_LE15 = 0.0011

#: §1: data pattern affects Multi-RowCopy success by 0.07% on average.
MRC_PATTERN_EFFECT_AVG_REL = 0.0007

#: Obs 17: 50C->90C varies MRC success by 0.04% on average.
MRC_TEMP_VARIATION_AVG_REL = 0.0004

#: Obs 18: VPP -0.4V decreases MRC success by at most 1.32%.
MRC_VPP_DROP_REL_MAX = 0.0132

#: Abstract: overall temp/voltage variation bound across ALL tested ops.
ALL_OPS_TEMP_VARIATION_MAX_REL = 0.0213
ALL_OPS_VPP_VARIATION_MAX_REL = 0.0132

# ---------------------------------------------------------------------------
# §7 Hypotheses (decoder + charge sharing)
# ---------------------------------------------------------------------------

#: §7.1: the examined chip has 2^16 rows/bank, 2^9 rows/subarray, 2^7
#: subarrays/bank, and (hypothesised) 5 predecoders => up to 2^5=32 rows.
DECODER_ROW_BITS = 9
DECODER_SUBARRAY_BITS = 7
DECODER_NUM_PREDECODERS = 5

#: §7.2 SPICE: MAJ3@32-row has 159.05% higher bitline deviation than @4-row.
SPICE_DEVIATION_GAIN_32_OVER_4_REL = 1.5905

#: §7.2 SPICE: success drop when process variation goes 0% -> 40%.
SPICE_MAJ3_4ROW_PV_DROP_REL = 0.4658
SPICE_MAJ3_32ROW_PV_DROP_REL = 0.0001

#: §3.5: Monte-Carlo iterations and PV levels used by the paper.
SPICE_MC_ITERS = 10_000
SPICE_PV_LEVELS = (0.0, 0.10, 0.20, 0.30, 0.40)

# ---------------------------------------------------------------------------
# §8 Case studies
# ---------------------------------------------------------------------------

#: §8.1: average speedup of new MAJX ops over the MAJ3@4-row baseline.
MICROBENCH_AVG_SPEEDUP_REL = {"M": 1.2161, "H": 0.4654}
#: §8.1: MAJ7 over MAJ5.
MICROBENCH_MAJ7_OVER_MAJ5_REL = {"M": 0.6210, "H": 0.3171}
#: §8.1: MAJ9 *degrades* performance by 114.12% on Mfr H.
MICROBENCH_MAJ9_DEGRADATION_H_REL = 1.1412

MICROBENCHMARKS = ("and", "or", "xor", "add", "sub", "mul", "div")
MICROBENCH_ELEM_BITS = 32
MICROBENCH_ELEM_BYTES = 8 * 1024  # 8KB elements

#: §8.2: Multi-RowCopy content destruction vs RowClone / Frac baselines.
COLDBOOT_MAX_SPEEDUP_VS_ROWCLONE = 20.87
COLDBOOT_MAX_SPEEDUP_VS_FRAC = 7.55

# ---------------------------------------------------------------------------
# Derived anchors (relative-percentage convention; see module docstring)
# ---------------------------------------------------------------------------

def maj3_success_4row() -> float:
    """MAJ3 at 4-row activation (no replication), random data, best timings."""
    return MAJX_SUCCESS_32ROW[3] / (1.0 + MAJ3_REPLICATION_GAIN_32_OVER_4_REL)


def majx_success_min_activation(x: int) -> float:
    """MAJX success at the smallest N that fits X operands unreplicated."""
    if x == 3:
        return maj3_success_4row()
    return MAJX_SUCCESS_32ROW[x] / (1.0 + MAJX_REPLICATION_GAIN_REL[x])


def majx_success_fixed_pattern(x: int) -> float:
    """MAJX@32-row success with the 0x00/0xFF pattern (Obs 9)."""
    return MAJX_SUCCESS_32ROW[x] / (1.0 - MAJX_RANDOM_BELOW_FIXED_REL[x])


def maj3_32_second_best_timing() -> float:
    """MAJ3@32 at the second-best timing (t1=t2=3ns), Obs 7."""
    return MAJX_SUCCESS_32ROW[3] / (1.0 + MAJ3_32_BEST_OVER_SECOND_REL)


def min_activation_for(x: int) -> int:
    """Smallest supported N-row activation holding X operands (>= X)."""
    for n in N_ACT_LEVELS:
        if n >= x:
            return n
    raise ValueError(f"MAJ{x} does not fit any activation level")


def replication_plan(x: int, n: int) -> tuple[int, int]:
    """(copies per operand, neutral rows) when running MAJX with N-row act.

    §3.3: replicate each of the X operands floor(N/X) times; the N%X
    leftover rows are neutral (Frac-initialised to VDD/2).
    """
    if n < x:
        raise ValueError(f"cannot run MAJ{x} with only {n} activated rows")
    return n // x, n % x


@dataclasses.dataclass(frozen=True)
class DeviceAnchor:
    """Per-manufacturer behaviour captured in the paper."""

    mfr: str
    supports_simra: bool
    supports_frac: bool
    #: §3.3 fn5: Mfr M sense amps are biased to one/zero; neutral rows are
    #: emulated by initialising them with all-zeros/ones.
    frac_via_bias: bool
    max_majx: int
    subarray_sizes: tuple[int, ...]


DEVICE_ANCHORS = {
    "H": DeviceAnchor("H", True, True, False, 9, (512, 640)),
    "M": DeviceAnchor("M", True, False, True, 7, (1024,)),
    # §9 Limitation 1: Samsung chips show no SiMRA at all.
    "S": DeviceAnchor("S", False, False, False, 0, (512,)),
}
