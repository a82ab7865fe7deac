"""32-bit results completed in the window over its seconds (the window
ends when the last request's results are complete)."""

from port_bench.harness.stats import rate


def read(rec):
    if "lanes" not in rec.work:
        return None
    return rate(rec.work["lanes"], rec.window_s)
