"""Mean wall of one coalesced batch, as ``SloMonitor.record_batch`` gets
it (the service reads the clock after synchronising the device)."""


def read(rec):
    xs = rec.host.get("batch_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
