"""Host time the session spends hashing a ``run_fused`` call's inputs,
in ms: the program spans ``session.program_key`` (the Program's content
key) and ``cache.lowering_digest`` (the certificate's check of the
megakernel tables), over the calls of ``session.run_fused``, from the
recording of drivers that open one.  Nothing without the spans."""

KEY_SPANS = ("session.program_key", "cache.lowering_digest")


def read(rec):
    spans = (rec.counters.get("program") or {}).get("spans", {})
    calls = spans.get("session.run_fused", {}).get("calls")
    if not calls or KEY_SPANS[0] not in spans:
        return None
    return sum(spans[n]["total_s"] for n in KEY_SPANS if n in spans) \
        / calls * 1e3
