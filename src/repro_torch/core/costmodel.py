"""The one CostModel: DRAM command latency, Fig. 5 power, H100 constants.

:class:`CostModel` prices both sides of every PUD-vs-accelerator
decision:

* **DRAM command side** — the :class:`OpLatency` table (per-issue ns of
  MAJX-APA, Multi-RowCopy, RowClone, Frac, row WR/RD) plus the Fig. 5
  power series, composed into retry-aware per-op
  :meth:`~CostModel.latency_ns` / :meth:`~CostModel.energy_nj` and
  whole-:class:`~repro_torch.pud.isa.Program` totals.  These price an op
  under the calibration point (manufacturer error surfaces, temperature,
  VPP) the execution backends run under — pass the
  :class:`~repro_torch.backends.context.ExecutionContext`'s error model
  and ``env()`` kwargs.  This side is a copy of the reference package's
  and prices every Program identically.
* **GPU side** — an NVIDIA H100 SXM profile: ``peak_flops`` /
  ``hbm_bytes_per_s`` / ``nvlink_bytes_per_s`` (the roofline terms, from
  NVIDIA's H100 data sheet), ``kernel_launch_ns`` (the per-dispatch host
  overhead program fusion amortizes) and the energy constants
  ``board_w`` (board power while a dispatch is in flight) and
  ``hbm_pj_per_byte`` (DRAM access energy per byte moved), composed into
  :meth:`~CostModel.dispatch_overhead` / :meth:`~CostModel.
  dispatch_energy_nj` / :meth:`~CostModel.hbm_energy_nj`.

Unit convention: power is watts, time is nanoseconds, so energy is
``W x ns = nJ`` everywhere (1 W for 1 ns is exactly 1 nJ).

This module lives in ``core`` and deliberately imports nothing above it;
``op``/``program`` arguments are duck-typed (``op.kind``/``op.x``/
``op.n_act``, ``program.ops``) so :class:`~repro_torch.pud.isa.PUDOp`
streams cost without an upward import.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import calibration as cal
from repro_torch.core import commands as cmd
from repro_torch.core import power as pw
from repro_torch.core.errormodel import ErrorModel, expected_retries

T = cmd.NOMINAL

#: Bits per DRAM row across one rank (8 KB row, §8.1 element layout).
ROW_BITS = 65536
#: Peak module bus bandwidth (DDR4-2400, 64-bit channel), bytes/ns.
BUS_BYTES_PER_NS = 19.2


@dataclasses.dataclass(frozen=True)
class OpLatency:
    """Latency (ns) of one issue of each PUD / support operation."""

    #: APA in charge-share mode + row-cycle close: t1 + t2 + tRAS + tRP.
    majx_apa: float = cal.MAJX_BEST_T1_NS + cal.MAJX_BEST_T2_NS + T.tras + T.trp
    #: APA in Multi-RowCopy mode.  Base schedule tRAS + t2 + tRAS + tRP =
    #: 90 ns plus a sense-amp drive extension for the 32-way fan-out;
    #: the total is *calibrated* to Fig. 17's 20.87x (the paper measures
    #: but does not print per-op latencies).
    mrc: float = 138.1
    #: Consecutive two-row activation (RowClone): tRAS + 6 + tRAS + tRP.
    rowclone: float = T.tras + 6.0 + T.tras + T.trp
    #: Frac neutral-row init: interrupted restore + precharge.  Calibrated
    #: to Fig. 17's RowClone/Frac = 20.87/7.55 ratio (see above).
    frac: float = 18.7 + T.trp
    #: Writing a full row over the bus: tRCD + burst stream + tWR + tRP.
    wr_row: float = T.trcd + (ROW_BITS / 8) / BUS_BYTES_PER_NS + T.twr + T.trp
    #: Reading a full row: tRCD + burst stream + tRP.
    rd_row: float = T.trcd + (ROW_BITS / 8) / BUS_BYTES_PER_NS + T.trp


LAT = OpLatency()


def majx_issue_ns(x: int, n_act: int) -> float:
    """One MAJX issue including operand staging (§8.1 methodology).

    RowClone the X operands into the group (X ops), Multi-RowCopy the
    replicas (one MRC covers the whole group), Frac the neutral rows.
    """
    copies, neutral = cal.replication_plan(x, n_act)
    setup = x * LAT.rowclone
    if copies > 1:
        setup += x * LAT.mrc  # one fan-out per operand
    setup += neutral * LAT.frac
    return setup + LAT.majx_apa


def majx_throughput_bits_per_s(
    x: int, n_act: int, errors: ErrorModel, **env
) -> float:
    """Correct result bits per second for one subarray issuing MAJX.

    throughput = ROW_BITS * success / (issue latency * expected retries)
    — the §8.1 analytical model with our calibrated surfaces.
    """
    s = errors.majx_success(x, n_act, **env)
    t_ns = majx_issue_ns(x, n_act) * expected_retries(s)
    return ROW_BITS * s / (t_ns * 1e-9)


def mrc_throughput_rows_per_s(n_act: int, errors: ErrorModel, **env) -> float:
    """Destination rows written per second by Multi-RowCopy."""
    s = errors.mrc_success(n_act - 1, **env)
    t_ns = LAT.mrc * expected_retries(s)
    return (n_act - 1) / (t_ns * 1e-9)


#: Power series behind each non-SiMRA op kind (Fig. 5 / §8 methodology):
#: RowClone-style copies and Frac inits pay ACT+PRE power; row I/O pays
#: the bus-transfer series.  MAJ/MRC pay :func:`repro_torch.core.power.
#: simra_power_w` at their activation count and are handled inline.
_KIND_SERIES = {"NOT": "ACT_PRE", "COPY": "ACT_PRE", "FRAC": "ACT_PRE",
                "WR": "WR", "RD": "RD"}


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Shared latency / power / H100-constant model (see module docstring).

    Frozen: the default :data:`COST` instance is the repo-wide pricing
    authority; derive a variant with :func:`dataclasses.replace` for
    what-if studies (e.g. a different interconnect generation).

    Attributes:
        lat: per-issue DRAM command latencies (ns).
        peak_flops: H100 SXM dense bf16 tensor-core peak, 989 TFLOP/s
            (NVIDIA H100 data sheet).
        hbm_bytes_per_s: H100 SXM HBM3 bandwidth, 3.35 TB/s (data sheet).
        nvlink_bytes_per_s: NVLink bandwidth each way between two cards
            of one host, 450 GB/s (data sheet: 900 GB/s both ways).
        kernel_launch_ns: host-side overhead per kernel dispatch — the
            quantity program fusion amortizes, exactly as PULSAR
            amortizes DRAM command overhead across simultaneously
            activated rows.  Measured: the host wall time of one launch
            through a kernel wrapper, 39,772 ns on an NVIDIA H100 80GB
            HBM3 at its 700 W limit (``chip_smoke.py``, phase
            ``launch``; PERF.md keeps each run's value).
        board_w: board power while a dispatch is in flight — the
            H100 SXM's 700 W power limit (data sheet maximum; a card set
            lower reports its limit through ``nvidia-smi``, which
            ``chip_smoke.py`` prints).  Priced per launch over
            ``kernel_launch_ns``.
        hbm_pj_per_byte: DRAM access energy per byte through HBM
            (model assumption, ~3.75 pJ/bit HBM-class).
    """

    lat: OpLatency = LAT
    peak_flops: float = 989e12
    hbm_bytes_per_s: float = 3.35e12
    nvlink_bytes_per_s: float = 450e9
    kernel_launch_ns: float = 39_772.0
    board_w: float = 700.0
    hbm_pj_per_byte: float = 30.0

    # --------------------------------------------------- Fig. 5 power side
    def power_w(self, series: str) -> float:
        """Watts of one Fig. 5 series (``"REF"``, ``"SIMRA_32"``, ...).

        Raises :class:`ValueError` naming the valid series for unknown
        ops (e.g. a non-calibrated ``SIMRA_3``).
        """
        return pw.energy_nj(series, 1.0)  # W x 1 ns = the wattage in nJ

    def simra_power_w(self, n_act: int) -> float:
        """Average power of an N-row SiMRA activation loop (Obs 5)."""
        return pw.simra_power_w(n_act)

    # ------------------------------------------------- DRAM command side
    def latency_ns(self, op: str, *, x: int = 0, n_act: int = 0,
                   errors: Optional[ErrorModel] = None,
                   pipelined: bool = False, best_group: bool = False,
                   **env) -> float:
        """Expected latency of one op issue, retry-until-success.

        ``op`` is a :class:`~repro_torch.pud.isa.PUDOp` kind (``MAJ``/``MRC``/
        ``NOT``/``COPY``/``FRAC``/``WR``/``RD``).  With ``errors=None``
        the single-issue latency is returned (no retry model — what an
        ideal context pays); otherwise the calibrated success surfaces
        under ``env`` (``temp_c``/``vpp_v``, see
        :meth:`repro_torch.backends.context.ExecutionContext.env`) drive the
        geometric retry estimate.  ``pipelined`` drops MAJ operand
        staging; ``best_group`` uses the best-row-group success rates
        the §8 case studies select.
        """
        if op == "MAJ":
            retries = 1.0
            if errors is not None:
                if best_group:
                    s = cal.MAJX_BEST_GROUP_SUCCESS[errors.mfr].get(x, 0.005)
                else:
                    s = errors.majx_success(x, n_act, **env)
                retries = expected_retries(s)
            issue = (self.lat.majx_apa if pipelined
                     else majx_issue_ns(x, n_act))
            return issue * retries
        if op == "MRC":
            retries = 1.0
            if errors is not None:
                retries = expected_retries(
                    errors.mrc_success(n_act - 1, **env))
            return self.lat.mrc * retries
        if op in ("NOT", "COPY"):
            retries = 1.0
            if errors is not None:
                retries = expected_retries(
                    errors.mrc_success(1, t1=36.0, t2=6.0, **env))
            return self.lat.rowclone * retries
        if op == "FRAC":
            return self.lat.frac
        if op == "WR":
            return self.lat.wr_row
        if op == "RD":
            return self.lat.rd_row
        raise ValueError(f"unknown op kind {op!r}")

    def energy_nj(self, op: str, duration_ns: Optional[float] = None, *,
                  x: int = 0, n_act: int = 0,
                  errors: Optional[ErrorModel] = None, **env) -> float:
        """Energy (nJ) of one op issue — W x ns, both sides modelled here.

        Two calling styles:

        * ``energy_nj("REF", duration_ns=90.0)`` — hold a Fig. 5 power
          series for an explicit duration (the
          :func:`repro_torch.core.power.energy_nj` path, same ValueError on
          unknown series);
        * ``energy_nj("MAJ", x=3, n_act=32, errors=em)`` — one op-kind
          issue: SiMRA power at the activation count over the (retry
          -aware when ``errors`` given) issue latency for MAJ/MRC,
          ACT_PRE / WR / RD power over the command latency otherwise.
          Matching the §8 methodology (and the historical
          ``Program.energy_nj``), support-op retries are a *latency*
          phenomenon only — NOT/COPY energy prices one clean issue.
        """
        if duration_ns is not None:
            return pw.energy_nj(op, duration_ns)
        if op in ("MAJ", "MRC"):
            t = self.latency_ns(op, x=x, n_act=n_act, errors=errors, **env)
            return pw.simra_power_w(n_act) * t
        series = _KIND_SERIES.get(op)
        if series is None:
            raise ValueError(f"unknown op kind {op!r}")
        return pw.energy_nj(series, self.latency_ns(op))

    def program_latency_ns(self, program, errors: ErrorModel, *,
                           pipelined: bool = False,
                           best_group: bool = False, **env) -> float:
        """Expected execution time of a whole op stream (see
        :meth:`repro_torch.pud.isa.Program.latency_ns`, which delegates
        here)."""
        return sum(
            self.latency_ns(op.kind, x=op.x, n_act=op.n_act, errors=errors,
                            pipelined=pipelined, best_group=best_group,
                            **env)
            for op in program.ops)

    def program_energy_nj(self, program, errors: ErrorModel,
                          **env) -> float:
        """Energy of a whole op stream from the Fig. 5 power model (see
        :meth:`repro_torch.pud.isa.Program.energy_nj`, which delegates
        here)."""
        return sum(
            self.energy_nj(op.kind, x=op.x, n_act=op.n_act, errors=errors,
                           **env)
            for op in program.ops)

    # ----------------------------------------------------------- GPU side
    def hbm_ns(self, n_bytes: float) -> float:
        """Time (ns) to move ``n_bytes`` through HBM at full bandwidth."""
        return n_bytes / self.hbm_bytes_per_s * 1e9

    def hbm_energy_nj(self, n_bytes: float) -> float:
        """DRAM access energy of moving ``n_bytes`` through HBM."""
        return n_bytes * self.hbm_pj_per_byte * 1e-3  # pJ -> nJ

    def dispatch_overhead(self, n_dispatches: int = 1) -> float:
        """Host-side launch overhead (ns) of ``n_dispatches`` kernels —
        the structural cost fusion and the megakernel collapse."""
        return n_dispatches * self.kernel_launch_ns

    def dispatch_energy_nj(self, n_dispatches: int = 1) -> float:
        """Energy of ``n_dispatches`` kernel launches: board power held
        for each launch round-trip."""
        return n_dispatches * self.kernel_launch_ns * self.board_w


#: The port-wide pricing authority: the ``cuda`` backend's energy
#: counter and every later consumer read THIS instance.
COST = CostModel()

#: Single-source H100 constants.
PEAK_FLOPS = COST.peak_flops
HBM_BYTES_PER_S = COST.hbm_bytes_per_s
HBM_BW = COST.hbm_bytes_per_s
NVLINK_BW = COST.nvlink_bytes_per_s
KERNEL_LAUNCH_NS = COST.kernel_launch_ns
