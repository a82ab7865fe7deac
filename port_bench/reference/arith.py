"""Plain reference of the §8.1 microbenchmarks: uint32 add, sub and mul
that wrap modulo 2**32, in NumPy alone.

``control`` is the same arithmetic one precision below the exact integer
the configuration states: through float32, as a GPU's float units would
do it (a 24-bit significand), the step that would tempt a faster path.
"""

from __future__ import annotations

import numpy as np

_OPS = {"add": np.add, "sub": np.subtract, "mul": np.multiply}


def expected(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact uint32 results (numpy's uint32 arithmetic wraps)."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    with np.errstate(over="ignore"):
        return _OPS[op](a, b).astype(np.uint32)


def control(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The same results computed in float32, wrapped to uint32."""
    fa = np.asarray(a, np.uint32).astype(np.float32)
    fb = np.asarray(b, np.uint32).astype(np.float32)
    r = _OPS[op](fa, fb).astype(np.float64)
    return np.mod(np.floor(r), 2.0**32).astype(np.uint64).astype(np.uint32)


def wrong_lanes(op: str, a: np.ndarray, b: np.ndarray,
                got: np.ndarray) -> int:
    """Lanes of ``got`` that differ from the exact result (a shape that
    differs counts every lane wrong)."""
    want = expected(op, a, b)
    got = np.asarray(got, np.uint32)
    if got.shape != want.shape:
        return int(max(want.size, got.size))
    return int(np.count_nonzero(got != want))
