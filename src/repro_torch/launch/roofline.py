"""Roofline analysis from the dry run's counts (no card needed).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_chip / peak_FLOPs
    memory     = bytes_per_chip / HBM_bw
    collective = collective_bytes_per_chip / link_bw

Sources & methodology (the dry run, :mod:`repro_torch.launch.dryrun`):

* FLOPs and bytes are counted on one rank's local ops while the port's
  real step runs eagerly over DTensors, so every layer and every
  attention chunk is seen: the counts are at full depth, and
  :func:`compose` / :func:`compose_seq` are kept for cross-checks (a
  cell's full-depth count equals the composition of its depth-0 and
  depth-1 counts).
* collective bytes come from the collectives recorded during the run
  (:class:`CollectiveRecord`: kind, operand and result bytes):
  all-reduce counts 2x its operand (ring reduce-scatter + all-gather),
  all-gather its result, the others their operand.  The eager run
  records every layer's and every microbatch's op itself, so no loop
  multiplies them.
* the per-chip peak of live local bytes proves per-chip fit.

Hardware constants (989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink
each way) come from the one :data:`repro_torch.core.costmodel.COST`
model; the names below are re-exports, not definitions.  NVLink takes
the place of the reference's ICI link.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.costmodel import (
    HBM_BW as HBM_BW,
    NVLINK_BW as NVLINK_BW,
    PEAK_FLOPS as PEAK_FLOPS,
)

#: The collective kinds, by the reference's HLO names.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as one rank ran it."""

    kind: str
    operand_bytes: int
    result_bytes: int


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: float
    n_ops: int

    @property
    def dominant(self) -> str:
        if not self.bytes_by_kind:
            return "none"
        return max(self.bytes_by_kind, key=self.bytes_by_kind.get)


def wire_bytes(rec: CollectiveRecord) -> int:
    """The bytes one rank moves for ``rec`` (the reference's rules)."""
    if rec.kind == "all-reduce":
        return 2 * rec.operand_bytes  # ring reduce-scatter + all-gather
    if rec.kind == "all-gather":
        return rec.result_bytes
    return rec.operand_bytes


def collective_bytes(records: Iterable[CollectiveRecord]) -> CollectiveStats:
    """Sum the wire bytes of one rank's collectives by kind."""
    by_kind: dict[str, float] = {}
    n = 0
    for rec in records:
        by_kind[rec.kind] = by_kind.get(rec.kind, 0.0) + wire_bytes(rec)
        n += 1
    return CollectiveStats(by_kind, sum(by_kind.values()), n)


# ---------------------------------------------------------------------------
# analytic model FLOPs (the MODEL_FLOPS row of the table)
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training (2*N_active*D inference) + attention."""
    n_active = cfg.n_active_params()
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = gb * s
        base = 6 * n_active * tokens
        mult = 3  # fwd + bwd
    elif shape.kind == "prefill":
        tokens = gb * s
        base = 2 * n_active * tokens
        mult = 1
    else:  # decode: one token against an s-long context
        tokens = gb
        base = 2 * n_active * tokens
        mult = 1

    attn = 0.0
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        n_attn_layers = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // max(cfg.attn_every, 1)
    else:
        n_attn_layers = 0
    if n_attn_layers:
        h, hd = cfg.n_heads, cfg.hd
        if shape.kind == "decode":
            ctx = min(s, cfg.sliding_window) if cfg.sliding_window else s
            attn = 4 * gb * ctx * h * hd * n_attn_layers  # QK + PV
        else:
            eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
            # causal halves the S x S_eff score work
            attn = (4 * gb * s * eff * h * hd / 2) * n_attn_layers * mult
    return float(base + attn)


# ---------------------------------------------------------------------------
# composition of cost points
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CostPoint:
    flops: float
    bytes_accessed: float


def compose(cfg, points: dict[int, CostPoint]) -> CostPoint:
    """Combine depth points into the full-depth estimate."""
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        c0, c1 = points[0], points[1]
        return CostPoint(
            flops=c0.flops + cfg.n_layers * (c1.flops - c0.flops),
            bytes_accessed=c0.bytes_accessed
            + cfg.n_layers * (c1.bytes_accessed - c0.bytes_accessed))
    if cfg.family == "hybrid":
        a = cfg.attn_every
        c0, ca, ca1 = points[0], points[a], points[a + 1]
        body_f = ca1.flops - ca.flops
        body_b = ca1.bytes_accessed - ca.bytes_accessed
        attn_f = ca.flops - c0.flops - body_f
        attn_b = ca.bytes_accessed - c0.bytes_accessed - body_b
        n_full = cfg.n_layers // a
        return CostPoint(
            flops=c0.flops + cfg.n_layers * body_f + n_full * attn_f,
            bytes_accessed=(c0.bytes_accessed + cfg.n_layers * body_b
                            + n_full * attn_b))
    raise ValueError(f"no composition rule for family {cfg.family}")


def compose_seq(s_target: int, s_points: dict[int, CostPoint]) -> CostPoint:
    """Linear-in-S fit for recurrent (ssm) families."""
    (s1, c1), (s2, c2) = sorted(s_points.items())
    df = (c2.flops - c1.flops) / (s2 - s1)
    db = (c2.bytes_accessed - c1.bytes_accessed) / (s2 - s1)
    return CostPoint(flops=c1.flops + df * (s_target - s1),
                     bytes_accessed=c1.bytes_accessed + db * (s_target - s1))


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_dominant_kind: str
    model_flops_global: float
    mem_per_chip_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction: time the compute term would take at
        peak vs the dominant term (1.0 = perfectly compute-bound at peak
        with no redundant compute)."""
        t_ideal = self.model_flops_global / self.n_chips / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_bound if t_bound > 0 else 0.0

    @property
    def hlo_efficiency(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundant compute
        (the reference's name, kept for its rows)."""
        total_hlo = self.flops_per_chip * self.n_chips
        return self.model_flops_global / total_hlo if total_hlo else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "model_flops": self.model_flops_global,
            "hlo_flops_global": self.flops_per_chip * self.n_chips,
            "hlo_efficiency": self.hlo_efficiency,
            "coll_dominant": self.coll_dominant_kind,
            "mem_per_chip_gb": self.mem_per_chip_bytes / 2**30,
        }
