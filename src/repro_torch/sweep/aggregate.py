"""Aggregation: reduce sweep records to the paper's headline numbers.

Records are the flat dicts produced by :mod:`repro_torch.sweep.runner` (one
per grid point: identity fields + ``success`` + ``expected``).  The
reducers here are deliberately generic — group/filter/pivot — with the
paper's headline quantities (replication delta, data-pattern
sensitivity, temperature/voltage resilience) expressed on top of them,
so their callers carry no per-point loops of their own.

Every reducer accepts any ``Iterable[dict]`` — including one-shot
generators: functions that consume their input more than once
materialize it to a list exactly once at entry, so a generator argument
yields the same result as the equivalent list.
"""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Optional, Sequence


def filter_records(records: Iterable[dict], **eq) -> list[dict]:
    """Records whose fields equal every given keyword (e.g. x=3)."""
    return [r for r in records
            if all(r.get(k) == v for k, v in eq.items())]


def mean_success(records: Iterable[dict], field: str = "success",
                 **eq) -> float:
    """Mean of ``field`` over the matching records."""
    vals = [r[field] for r in filter_records(records, **eq)]
    if not vals:
        raise ValueError(f"no records match {eq}")
    return statistics.fmean(vals)


def group_mean(records: Iterable[dict], keys: Sequence[str],
               field: str = "success") -> dict[tuple, float]:
    """Pivot: mean of ``field`` per distinct tuple of ``keys`` values."""
    buckets: dict[tuple, list[float]] = {}
    for r in records:
        buckets.setdefault(tuple(r[k] for k in keys), []).append(r[field])
    return {k: statistics.fmean(v) for k, v in sorted(buckets.items())}


# ------------------------------------------------------- paper headlines


def replication_delta(records: Iterable[dict], x: int = 3, hi: int = 32,
                      lo: Optional[int] = None, **eq) -> float:
    """Obs 6/10: relative success gain of ``n_act=hi`` over ``n_act=lo``.

    Defaults to the paper's headline MAJ3@32-row vs @4-row comparison;
    returned as a relative fraction (0.3081 means +30.81 %).
    """
    from repro_torch.core import calibration as cal

    records = list(records)  # consumed twice below
    lo = lo if lo is not None else cal.min_activation_for(x)
    s_hi = mean_success(records, x=x, n_act=hi, **eq)
    s_lo = mean_success(records, x=x, n_act=lo, **eq)
    return s_hi / s_lo - 1.0


def pattern_sensitivity(records: Iterable[dict], **eq) -> dict[int, float]:
    """Obs 9: per arity, mean relative effect of fixed patterns vs random."""
    recs = filter_records(records, **eq)
    out: dict[int, float] = {}
    for x in sorted({r["x"] for r in recs}):
        base = mean_success(recs, x=x, pattern="random")
        fixed = [r["success"] for r in filter_records(recs, x=x)
                 if r["pattern"] != "random"]
        if fixed and base > 0:
            out[x] = statistics.fmean(fixed) / base - 1.0
    return out


def env_resilience(records: Iterable[dict], field: str,
                   baseline: float, **eq) -> float:
    """Obs 3/4/11-13/17/18: max relative success variation across an
    environment axis (``temp_c`` or ``vpp_v``) vs its nominal value.

    Groups with no record at the nominal ``baseline`` value are skipped
    (their variation is undefined).  A group whose baseline success is
    exactly ``0.0`` is *not* skipped: if it succeeds anywhere else on
    the axis its relative variation is unbounded and the function
    returns ``inf``; if it fails everywhere it contributes 0 variation.
    """
    recs = filter_records(records, **eq)
    groups = group_mean(recs, ("x", "n_act", "n_dest"))
    worst = 0.0
    for (x, n_act, n_dest), _ in groups.items():
        sub = filter_records(recs, x=x, n_act=n_act, n_dest=n_dest)
        by_env = group_mean(sub, (field,))
        base = by_env.get((baseline,))
        if base is None:
            continue  # no measurement at nominal conditions
        if base == 0.0:
            if any(v != 0.0 for v in by_env.values()):
                worst = float("inf")
            continue
        for v in by_env.values():
            worst = max(worst, abs(v / base - 1.0))
    return worst


def headline(records: Iterable[dict]) -> dict[str, float]:
    """Every headline quantity computable from the given records."""
    records = list(records)  # consumed once per headline below
    out: dict[str, float] = {}
    xs = {r["x"] for r in records}
    n_acts = {r["n_act"] for r in records}
    pats = {r["pattern"] for r in records}
    try:
        if 3 in xs and {4, 32} <= n_acts:
            out["maj3_32_over_4_rel"] = replication_delta(records)
    except ValueError:
        pass
    if len(pats) > 1 and "random" in pats:
        for x, d in pattern_sensitivity(records).items():
            out[f"pattern_effect_x{x}_rel"] = d
    for field, base, key in (("temp_c", 50.0, "temp_variation_max_rel"),
                             ("vpp_v", 2.5, "vpp_variation_max_rel")):
        if len({r[field] for r in records}) > 1:
            out[key] = env_resilience(records, field, base)
    return out


def success_table(records: Iterable[dict], row_keys: Sequence[str],
                  fmt: Callable[[float], str] = "{:.4f}".format
                  ) -> list[str]:
    """Markdown table of mean success per ``row_keys`` group."""
    lines = ["| " + " | ".join(row_keys) + " | success |",
             "|" + "---|" * (len(row_keys) + 1)]
    for key, s in group_mean(records, row_keys).items():
        cells = " | ".join(str(k) for k in key)
        lines.append(f"| {cells} | {fmt(s)} |")
    return lines
