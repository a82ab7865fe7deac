"""Plain reference of the PUD integrity service's three answers, in NumPy
alone, over packed uint32 tiles.

* heal: the bitwise majority of the replicas, and the bits it fixed
  against replica 0;
* erase: every word of every row is the pattern;
* verify: the bits in which live and reference differ.

``control_heal`` breaks the heal's guarantee the cheap way a faster path
might: it answers replica 0 as it stands, with no vote.
"""

from __future__ import annotations

import numpy as np


def popcount(words: np.ndarray) -> int:
    """Set bits of uint32 words (SWAR, in uint64 so nothing wraps)."""
    w = np.asarray(words, np.uint32).astype(np.uint64).reshape(-1)
    w = w - ((w >> np.uint64(1)) & np.uint64(0x55555555))
    w = (w & np.uint64(0x33333333)) + ((w >> np.uint64(2))
                                       & np.uint64(0x33333333))
    w = (w + (w >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    w = (w * np.uint64(0x01010101)) & np.uint64(0xFFFFFFFF)
    return int((w >> np.uint64(24)).sum())


def heal(replicas: np.ndarray) -> np.ndarray:
    """Bitwise majority of an odd number of replicas (x, rows, words)."""
    reps = np.asarray(replicas, np.uint32)
    x = reps.shape[0]
    if x == 3:
        a, b, c = reps
        return (a & b) | (a & c) | (b & c)
    counts = np.zeros(reps.shape[1:] + (32,), np.int16)
    for r in reps:
        counts += np.unpackbits(r.view(np.uint8), bitorder="little"
                                ).reshape(counts.shape)
    bits = (counts > x // 2).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").view(
        np.uint32).reshape(reps.shape[1:])


def fixed_bits(replicas: np.ndarray) -> int:
    return popcount(np.asarray(replicas, np.uint32)[0] ^ heal(replicas))


def control_heal(replicas: np.ndarray) -> tuple[np.ndarray, int]:
    """Replica 0 unvoted, and no bit fixed."""
    return np.asarray(replicas, np.uint32)[0].copy(), 0


def erase(rows: int, words: int, pattern: int) -> np.ndarray:
    return np.full((rows, words), pattern, np.uint32)


def verify(live: np.ndarray, ref: np.ndarray) -> int:
    return popcount(np.asarray(live, np.uint32) ^ np.asarray(ref, np.uint32))


def tile_bits_wrong(want: np.ndarray, got: np.ndarray) -> int:
    """Bits of ``got`` that differ from ``want`` (every bit where the
    shapes differ)."""
    got = np.asarray(got, np.uint32)
    if got.shape != want.shape:
        return 32 * int(max(want.size, got.size))
    return popcount(got ^ want)


def words_wrong(want: np.ndarray, got: np.ndarray) -> int:
    got = np.asarray(got, np.uint32)
    if got.shape != want.shape:
        return int(max(want.size, got.size))
    return int(np.count_nonzero(got != want))
