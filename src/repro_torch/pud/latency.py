"""Command-schedule latency & throughput model — compatibility shim.

The latency table and throughput helpers live in
:mod:`repro_torch.core.costmodel`, so the DRAM side and the GPU side of
every offload decision are priced by ONE :class:`~repro_torch.core.
costmodel.CostModel` (latency *and* energy).  This module re-exports the
public names under the reference package's ``pud.latency`` path
(:mod:`repro_torch.pud.offload` reads them here); new code should import
from ``repro_torch.core.costmodel`` directly.
"""

from __future__ import annotations

from repro_torch.core.costmodel import (
    BUS_BYTES_PER_NS as BUS_BYTES_PER_NS,
    LAT as LAT,
    ROW_BITS as ROW_BITS,
    T as T,
    OpLatency as OpLatency,
    majx_issue_ns as majx_issue_ns,
    majx_throughput_bits_per_s as majx_throughput_bits_per_s,
    mrc_throughput_rows_per_s as mrc_throughput_rows_per_s,
)

__all__ = [
    "BUS_BYTES_PER_NS",
    "LAT",
    "ROW_BITS",
    "T",
    "OpLatency",
    "majx_issue_ns",
    "majx_throughput_bits_per_s",
    "mrc_throughput_rows_per_s",
]
