"""Device operations (kernels, copies, memsets) in the traced window over
the requests completed in it."""


def read(rec):
    t = rec.trace
    if t is None or not t.count() or not rec.work.get("requests"):
        return None
    return t.count() / rec.work["requests"]
