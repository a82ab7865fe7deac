"""Mean host time of one ``DramSession.run_fused`` call (validation, the
program key, the compile cache, the backend's launches; it returns
before the card finishes)."""


def read(rec):
    xs = rec.host.get("run_fused_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
