"""Plain reference of the §8.1 division microbenchmark: uint32 floor
division, in NumPy alone.  A divisor of 0 gives 0xFFFFFFFF, the
convention of the bit-serial restoring divider (all quotient bits set).

``control`` is the same division one precision below the exact integer
the configuration states: through float32, as a GPU's float units would
do it (a 24-bit significand), the step that would tempt a faster path.
It keeps the divide-by-zero convention, so it differs by precision alone.
"""

from __future__ import annotations

import numpy as np

ALL_ONES = 0xFFFFFFFF


def expected(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact uint32 quotients."""
    if op != "div":
        raise ValueError(f"unknown op {op!r}")
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    q = a // np.maximum(b, 1)
    return np.where(b == 0, np.uint32(ALL_ONES), q).astype(np.uint32)


def control(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The quotients computed in float32 and floored, wrapped to uint32."""
    if op != "div":
        raise ValueError(f"unknown op {op!r}")
    b = np.asarray(b, np.uint32)
    fa = np.asarray(a, np.uint32).astype(np.float32)
    fb = np.maximum(b, 1).astype(np.float32)
    r = np.floor((fa / fb).astype(np.float64))
    q = np.mod(r, 2.0**32).astype(np.uint64).astype(np.uint32)
    return np.where(b == 0, np.uint32(ALL_ONES), q).astype(np.uint32)


def wrong_lanes(op: str, a: np.ndarray, b: np.ndarray,
                got: np.ndarray) -> int:
    """Lanes of ``got`` that differ from the exact quotient (a shape that
    differs counts every lane wrong)."""
    want = expected(op, a, b)
    got = np.asarray(got, np.uint32)
    if got.shape != want.shape:
        return int(max(want.size, got.size))
    return int(np.count_nonzero(got != want))
