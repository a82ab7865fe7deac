"""Mean of each request's ``queued`` span (``RequestTrace``: admission to
the batching tick that drains it), as the service records it."""


def read(rec):
    xs = rec.host.get("queued_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
