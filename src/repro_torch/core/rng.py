"""Counter-based random draws: threefry2x32 in integer torch ops.

The port's counterpart of the ``jax.random`` calls the reference makes,
word for word with jax 0.9.0 under its defaults
(``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``, ``jax_enable_x64=False``):

* a key is a ``(2,)`` int32 tensor on the CPU holding the two uint32
  key words (the port's packed-word convention, see
  :mod:`repro_torch.core.bitplanes`); :func:`PRNGKey`, :func:`split`
  and :func:`fold_in` hash on the host in Python integers, so deriving
  a key launches nothing;
* a draw over a shape hashes the 64-bit flat index of every element
  (high word 0, low word the row-major index, the partitionable
  counter layout) under the key, and XORs the two output words
  (:func:`random_bits`).  It runs on the ``device`` it is asked for
  (the card unless the caller asks for the CPU), in int32 ops that wrap, with every right shift masked, so the CPU and
  the card give the same words;
* :func:`uniform` builds floats from the top 23 bits (``bits >> 9 |
  0x3F800000``, minus 1) as jax does, then scales to ``[minval,
  maxval)``.  XLA on the CPU fuses that scale into one multiply-add,
  so the port rounds it once too (through float64) and clamps to
  ``minval``; with the default ``[0, 1)`` the scale is exact and
  skipped.

``randint`` is not here: the reference's one call
(``Subarray.fill("random")``, ``randint`` over uint32 with ``maxval =
1 << 32``) raises ``OverflowError`` under jax 0.9.0, and the port draws
the uniform words it means with :func:`random_bits`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(v: int) -> int:
    """uint32 value -> the Python int with the same int32 bit pattern."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


# ------------------------------------------------------ scalar (host) hash
def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _hash_scalar(k1: int, k2: int, x1: int, x2: int) -> tuple[int, int]:
    """threefry2x32 of one counter pair, in Python integers."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) word pair, got shape "
                         f"{tuple(key.shape)}")
    k1, k2 = (int(v) & _M32 for v in key.tolist())
    return k1, k2


def _make_key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([_i32(k1), _i32(k2)], dtype=torch.int32)


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of an integer seed: ``[0, seed mod 2**32]``, as
    ``jax.random.PRNGKey`` makes it with 64-bit types disabled."""
    return _make_key(0, int(seed))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape ``(num, 2)``: key ``i`` is the hash of
    the counter pair ``(0, i)``."""
    k1, k2 = _key_words(key)
    out = torch.empty((num, 2), dtype=torch.int32)
    for i in range(num):
        a, b = _hash_scalar(k1, k2, 0, i)
        out[i, 0], out[i, 1] = _i32(a), _i32(b)
    return out


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from ``key`` and a 32-bit integer: the hash of the
    counter pair ``(0, data)``."""
    k1, k2 = _key_words(key)
    return _make_key(*_hash_scalar(k1, k2, 0, int(data) & _M32))


# ------------------------------------------------------ tensor (bulk) hash
def _rotl_(v: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 words left by ``r`` in place; the right shift
    sign-extends, so its result is masked to its ``r`` low bits."""
    hi = v << r
    v.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
    return v.bitwise_or_(hi)


def _hash_lanes(k1: int, k2: int, lo: torch.Tensor) -> torch.Tensor:
    """threefry2x32 of the counter pairs ``(0, lo)``, XOR of the two
    output words; ``lo`` (int32) is consumed."""
    ks = (_i32(k1), _i32(k2), _i32(k1 ^ k2 ^ _PARITY))
    b = lo.add_(ks[1])
    a = torch.full_like(b, ks[0])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b)
            _rotl_(b, r).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3])
        b.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return a.bitwise_xor_(b)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device="cuda") -> torch.Tensor:
    """Uniform 32-bit words of ``shape`` on ``device``, as int32 bit
    patterns: ``jax.random.bits(key, shape, jnp.uint32)``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= 1 << 31:
        raise ValueError(f"draw of {n} words: the port counts lanes in "
                         f"int32 and supports fewer than 2**31")
    k1, k2 = _key_words(key)
    lanes = torch.arange(n, dtype=torch.int32, device=device)
    return _hash_lanes(k1, k2, lanes).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0,
            device="cuda") -> torch.Tensor:
    """float32 draws in ``[minval, maxval)``: ``jax.random.uniform``."""
    bits = random_bits(key, shape, device)
    bits.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
    floats = bits.bitwise_or_(0x3F800000).view(torch.float32).sub_(1.0)
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    if float(lo) == 0.0 and float(hi) == 1.0:
        return floats
    scale = float(hi - lo)
    out = (floats.double() * scale + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Sequence[int] = (), device="cuda") -> torch.Tensor:
    """Boolean draws, true with probability ``p``:
    ``jax.random.bernoulli(key, p, shape)`` (its default ``low`` mode)."""
    return uniform(key, shape, device=device) < f32(p)


def f32(v: float) -> float:
    """``v`` rounded to float32, as jax casts a weakly typed scalar."""
    return float(torch.tensor(v, dtype=torch.float32))
