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
from repro_torch.core import rng
from repro_torch.core import tree as tree_util


def _tensor_words(t: torch.Tensor) -> torch.Tensor:
    """A tensor's values as int32 words, modulo 2**32 as
    ``np.asarray(t, np.uint32)`` takes them, on the tensor's own device:
    uint32 is a view, narrower integers widen, anything else is masked to
    its low 32 bits through int64."""
    if t.dtype == torch.int32:
        return t
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype.itemsize < 4 and not t.dtype.is_floating_point:
        return t.to(torch.int32)
    return bp.wrap_i32(t.to(torch.int64) & 0xFFFFFFFF)


def _replica_words(replicas) -> torch.Tensor:
    """Replicas as one int32 word tensor, from whatever the reference's
    ``jnp.asarray(replicas, jnp.uint32)`` takes: a tensor, or a sequence
    of tensors, converts on its device (:func:`_tensor_words`); numpy
    arrays, lists of rows and scalars go through
    :func:`~repro_torch.core.bitplanes.from_u32` onto the CPU."""
    if isinstance(replicas, torch.Tensor):
        return _tensor_words(replicas)
    rows = list(replicas)
    if rows and all(isinstance(r, torch.Tensor) for r in rows):
        return _tensor_words(torch.stack(rows))
    return bp.from_u32(rows, "cpu")


def vote_words(replicas) -> torch.Tensor:
    """Bitwise majority over replicas, shape (X, ...) words, odd X."""
    replicas = _replica_words(replicas)
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


def corrupt(x: torch.Tensor, key, bit_error_rate: float) -> torch.Tensor:
    """Inject i.i.d. bit flips (SDC model) — used by tests and demos.

    ``key`` is either a :mod:`repro_torch.core.rng` key — the flips are
    then drawn on ``x``'s device and equal the reference's
    ``jax.random.bernoulli`` draws under the same key — or a
    ``torch.Generator``, whose draws (on the generator's device, the mask
    then moved to ``x``'s) a seed fixes but the reference does not make.
    """
    words, shape, dtype = bp.bitcast_to_planes(x)
    n_bits = words.numel() * 32
    if isinstance(key, torch.Generator):
        flip_bits = torch.rand(n_bits, generator=key,
                               device=key.device) < bit_error_rate
    else:
        flip_bits = rng.bernoulli(key, bit_error_rate, (n_bits,),
                                  device=words.device)
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
