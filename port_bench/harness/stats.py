"""Rates and tails, over all the samples of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile of every value (linear between order
    statistics, as numpy's default): a tail of all requests, never a
    median of per-chunk tails."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all its seconds."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds
