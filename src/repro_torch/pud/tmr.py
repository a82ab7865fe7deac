"""X-modular-redundancy majority voting built on MAJX (paper §8.1).

The paper points out that MAJ3/5/7/9 directly implement triple (and
wider) modular redundancy voting in memory: MAJX corrects up to
floor(X/2) faulty replicas.  In this framework the voter protects
*checkpoint and optimizer state* against silent data corruption at scale
(see :mod:`repro_torch.ckpt.tmr_store`): replicas are bitwise-voted on
restore, so a corrupted shard on any minority of replicas is healed
without recomputation.

``vote_words`` is the closed-form digital vote on packed words (plain
PyTorch: the oracle of the MAJX kernel's TMR entry point,
:func:`repro_torch.kernels.majx.ops.vote`).  Packed words are int32
tensors holding uint32 bit patterns (:mod:`repro_torch.core.bitplanes`).
"""

from __future__ import annotations

from math import comb
from typing import Sequence

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import tree as tree_util


def vote_words(replicas) -> torch.Tensor:
    """Bitwise majority over replicas, shape (X, ...) int32, odd X."""
    if not isinstance(replicas, torch.Tensor):
        replicas = torch.stack(list(replicas))
    if replicas.dtype != torch.int32:
        raise TypeError(f"packed words are int32, got {replicas.dtype}")
    x = replicas.shape[0]
    if x % 2 == 0:
        raise ValueError("XMR vote needs an odd replica count")
    if x == 3:
        return bp.maj3_words(replicas[0], replicas[1], replicas[2])
    return bp.majority_words(replicas, axis=0)


def vote_array(replicas: Sequence[torch.Tensor]) -> torch.Tensor:
    """Majority-vote arbitrary same-shape/dtype tensors bitwise.

    Works for f32/bf16/f16/i8/u8/i32 etc. by voting on the raw words —
    bit-exact healing, no numerics involved.
    """
    words = []
    shape = dtype = None
    for r in replicas:
        w, shape, dtype = bp.bitcast_to_planes(r)
        words.append(w)
    voted = vote_words(torch.stack(words))
    return bp.bitcast_from_planes(voted, shape, dtype)


def vote_pytree(replicas: Sequence) -> object:
    """Vote an entire tree of tensors (e.g. a checkpoint)."""
    flats = [tree_util.flatten(r) for r in replicas]
    structure = flats[0][1]
    leaves = [vote_array([f[0][i] for f in flats])
              for i in range(len(flats[0][0]))]
    return tree_util.unflatten(structure, leaves)


def corrupt(x: torch.Tensor, generator: torch.Generator,
            bit_error_rate: float) -> torch.Tensor:
    """Inject i.i.d. bit flips (SDC model) — used by tests and demos.

    The flips are drawn from ``generator`` (on the CPU; the mask moves to
    ``x``'s device), so a seed fixes them; they are not the reference's
    ``jax.random`` draws.
    """
    words, shape, dtype = bp.bitcast_to_planes(x)
    flip_bits = torch.rand(words.numel() * 32, generator=generator,
                           device=generator.device) < bit_error_rate
    flips = bp.pack(flip_bits.reshape(words.numel(), 32)).reshape(
        words.shape)
    return bp.bitcast_from_planes(words ^ flips.to(words.device), shape,
                                  dtype)


def residual_word_error_rate(bit_error_rate: float, x: int = 3,
                             word_bits: int = 32) -> float:
    """Analytic post-vote word error rate for i.i.d. flips.

    A bit survives unless >= ceil(X/2) replicas flip it; a word fails if
    any of its bits fail.  Used by tests to check the voter hits theory.
    """
    p = bit_error_rate
    need = (x + 1) // 2
    p_bit = sum(comb(x, k) * p**k * (1 - p) ** (x - k)
                for k in range(need, x + 1))
    return 1.0 - (1.0 - p_bit) ** word_bits
