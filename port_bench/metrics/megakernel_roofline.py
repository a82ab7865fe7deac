"""The megakernel mode's share of its bytes bound, in %: every image run
read once and written once (``2 x rows x words x 4`` B) over 3.35 TB/s,
over the device time of all the work ``run_fused`` launched in that mode
(the kernel and, in its streaming regime, the copy it runs in place on).
Nothing where an operation's launch could not be placed."""

from port_bench.harness.peaks import share_percent


def read(rec):
    t = rec.trace
    if t is None or rec.counters.get("mode") != "megakernel" or \
            not t.count("megakernel") or (t.launch < 0).any():
        return None
    return share_percent(rec.counters["image_bytes"],
                         t.device_s(mask=t.launched_in("bench.run_fused")))
