"""Share of the traced window in %, in which no kernel, copy or memset
runs on the device (the union of the trace's device intervals)."""


def read(rec):
    t = rec.trace
    if t is None or not t.count() or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
