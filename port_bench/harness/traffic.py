"""The general traffic generator: what a traffic file's parameters and
``--seed`` make.

Every seed gets the same set of sizes and kinds, in another order: the
kinds of a mix are dealt from a deck that holds each kind its weight
times ``copies``, drawn from the seed without replacement and shuffled
anew each time it runs out.  Any stretch of the window holds the mix's
proportions to within one deck, while which kind follows which is as
good as independent (a kind of share ``p`` follows itself with
probability ``p (n p - 1) / (n - 1)`` in a deck of ``n``).
Sub-seeds for a request's inputs come from numpy's ``SeedSequence`` over
``(seed, *index)``, so an input can be made again from its index after
the window.
"""

from __future__ import annotations

import random
from typing import Iterator

import numpy as np

#: Large seeds (beyond 32 bits) are fine: SeedSequence takes any int.
_MASK63 = 2**63 - 1


def sub_seed(seed: int, *index: int) -> int:
    """A 63-bit seed for one input of one request."""
    ss = np.random.SeedSequence([int(seed) & (2**128 - 1),
                                 *[int(i) + 2**32 for i in index]])
    return int(ss.generate_state(1, np.uint64)[0]) & _MASK63


def mix_sequence(mix: dict[str, int], copies: int, seed: int,
                 *stream: int) -> Iterator[str]:
    """Kinds of ``mix`` (kind -> weight) dealt from a deck of each kind
    ``weight x copies`` times, reshuffled from the seed for every deal."""
    rng = random.Random(sub_seed(seed, 0x6D6978, *stream))
    deck = [k for k, w in sorted(mix.items())
            for _ in range(int(w) * int(copies))]
    if not deck:
        raise ValueError(f"empty mix {mix!r}")
    while True:
        rng.shuffle(deck)
        yield from deck


def pool_order(n: int, seed: int, *stream: int) -> Iterator[int]:
    """Indices of a pool of ``n`` entries, each pass a new shuffle."""
    rng = random.Random(sub_seed(seed, 0x706F6F6C, *stream))
    while True:
        order = list(range(n))
        rng.shuffle(order)
        yield from order


def tenants(counts: dict[str, int]) -> list[tuple[str, int]]:
    """One ``(kind, index)`` a closed-loop client, kinds interleaved."""
    out = []
    for i in range(max(counts.values())):
        for kind in sorted(counts):
            if i < counts[kind]:
                out.append((kind, i))
    return out


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from the
    seed (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int, *stream: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(sub_seed(seed, 0x72657376, *stream))

    def offer(self, make) -> None:
        """Offer the next item; ``make()`` builds it only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self._rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()
