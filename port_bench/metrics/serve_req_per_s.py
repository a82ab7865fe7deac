"""Replies delivered in the window over its seconds (the window ends at
the last reply)."""

from port_bench.harness.stats import rate


def read(rec):
    if "lanes" in rec.work or not rec.work.get("requests"):
        return None
    return rate(rec.work["requests"], rec.window_s)
