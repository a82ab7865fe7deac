"""95th percentile over every request of the window of client submit ->
reply, on the client's clock."""

from port_bench.harness.stats import percentile


def read(rec):
    if "lanes" in rec.work or not rec.latencies_s:
        return None
    return percentile(rec.latencies_s, 95) * 1e3
