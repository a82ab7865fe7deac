"""Device time of one plan level of the megakernel, in us: the device
seconds of the megakernel kernels launched inside ``bench.run_fused``
over the plan levels those launches ran (the program's counter
``megakernel.levels``, recorded over the traced window by drivers that
open a recording).  Nothing without the counter, a megakernel launch,
or where an operation's launch could not be placed."""


def read(rec):
    t = rec.trace
    levels = (rec.counters.get("program") or {}).get(
        "counters", {}).get("megakernel.levels")
    if t is None or not levels or not t.count("megakernel") or \
            (t.launch < 0).any():
        return None
    mask = t.launched_in("bench.run_fused")
    return 1e6 * t.device_s(mask=mask, name_has="megakernel") / levels
