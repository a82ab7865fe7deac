"""95th percentile over every request of the window of issue -> results
complete on the card, as the client that waits on its event sees it."""

from port_bench.harness.stats import percentile


def read(rec):
    if "lanes" not in rec.work or not rec.latencies_s:
        return None
    return percentile(rec.latencies_s, 95) * 1e3
