"""The whole request's share of its bytes bound, in %: 12 B a completed
lane (two 32-bit operands read, one result written) over 3.35 TB/s,
over the window.  It holds whatever implements the arithmetic."""

from port_bench.harness.peaks import HBM_BYTES_PER_S


def read(rec):
    if "lanes" not in rec.work:
        return None
    return 100.0 * rec.work["lanes"] * 12 / HBM_BYTES_PER_S / rec.window_s
