"""The MAJX kernel's share of its bytes bound, in %: each MAJ op of the
Programs run in the window reads its source rows once and writes its
destination rows once, over 3.35 TB/s, over the MAJX kernel's device
time in the trace."""

from port_bench.harness.peaks import share_percent


def read(rec):
    t = rec.trace
    if t is None or not t.count("majx_kernel"):
        return None
    return share_percent(rec.counters.get("maj_bytes", 0),
                         t.device_s(name_has="majx_kernel"))
