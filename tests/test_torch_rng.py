"""The port's threefry2x32 draws against ``jax.random``, word for word.

``repro_torch.core.rng`` is the port's counterpart of the ``jax.random``
calls the reference makes (``PRNGKey``, ``split``, ``fold_in``,
``bits``, ``uniform`` with and without a range, ``bernoulli``).  Every
draw here is compared bit for bit with jax 0.9.0 under its defaults
(threefry2x32, partitionable counters, 64-bit types disabled): keys as
uint32 words, floats as their bit patterns.  ``chip_smoke.py`` holds the
card to literal vectors, which the last test recomputes with jax.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(), (0,), (1,), (7,), (3, 5), (2, 3, 4), (1, 33), (5, 0, 2)]
SEEDS = [0, 1, 20261017, -3, 2**31 + 5]


def u32(t) -> np.ndarray:
    """A port draw (int32 words or float32) or a jax draw as uint32."""
    if isinstance(t, torch.Tensor):
        t = t.numpy()
    a = np.asarray(t)
    if a.dtype == np.bool_:
        return a.astype(np.uint32)
    return np.ascontiguousarray(a).view(np.uint32)


def test_keys_equal_jax():
    for seed in SEEDS:
        k = rng.PRNGKey(seed)
        assert k.dtype == torch.int32 and k.shape == (2,)
        assert (u32(k) == u32(jax.random.PRNGKey(seed))).all()
        for num in (1, 2, 5):
            assert (u32(rng.split(k, num)) ==
                    u32(jax.random.split(jax.random.PRNGKey(seed), num))
                    ).all()
        for data in (0, 1, 0x7FFFFFFF, 2**32 - 1, hash("apa") & 0x7FFFFFFF):
            assert (u32(rng.fold_in(k, data)) ==
                    u32(jax.random.fold_in(jax.random.PRNGKey(seed), data))
                    ).all()


def test_keys_chain_like_jax():
    """split of a split of a fold_in: the sim's derivations nest so."""
    k, kj = rng.PRNGKey(9), jax.random.PRNGKey(9)
    for i in range(6):
        k = rng.split(rng.fold_in(k, i * 7919))[1]
        kj = jax.random.split(jax.random.fold_in(kj, i * 7919))[1]
    assert (u32(k) == u32(kj)).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_equal_jax(shape):
    for seed in SEEDS:
        got = rng.random_bits(rng.PRNGKey(seed), shape, "cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
        assert (u32(got) == u32(want)).all()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.4, 0.4), (-0.1, 0.1),
                                   (2.0, 3.5), (0.25, 0.75)])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_equal_jax(shape, lo, hi):
    for seed in SEEDS[:3]:
        got = rng.uniform(rng.PRNGKey(seed), shape, lo, hi, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                  minval=lo, maxval=hi)
        assert (u32(got) == u32(want)).all()


@pytest.mark.parametrize("p", [0.0, 1e-3, 0.3, 0.5, 0.9999, 1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bernoulli_equal_jax(shape, p):
    got = rng.bernoulli(rng.PRNGKey(4), p, shape, "cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    want = jax.random.bernoulli(jax.random.PRNGKey(4), p, shape)
    assert (u32(got) == u32(want)).all()


def test_large_draws_equal_jax():
    """2**20 words and floats, where the scale of a ranged uniform is
    the multiply-add XLA fuses: every one bit-identical."""
    k, kj = rng.PRNGKey(5), jax.random.PRNGKey(5)
    n = (1 << 20) + 3
    assert (u32(rng.random_bits(k, (n,), "cpu")) ==
            u32(jax.random.bits(kj, (n,), jnp.uint32))).all()
    assert (u32(rng.uniform(k, (n,), -0.3, 0.3, "cpu")) ==
            u32(jax.random.uniform(kj, (n,), minval=-0.3,
                                   maxval=0.3))).all()


def test_stable_mask_equals_reference():
    from repro.core.errormodel import ErrorModel as RefModel
    from repro_torch.core.errormodel import ErrorModel

    for shape, s in (((64 * 32,), 0.93), ((3, 512), 0.5), ((2, 7), 1.0),
                     ((5,), 0.0)):
        got = ErrorModel("H").stable_mask(rng.PRNGKey(2), shape, s, "cpu")
        want = RefModel("H").stable_mask(jax.random.PRNGKey(2), shape, s)
        assert got.dtype == torch.bool and (u32(got) == u32(want)).all()


def test_random_bits_refuses_a_draw_past_int32_lanes():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        rng.random_bits(rng.PRNGKey(0), (1 << 16, 1 << 15), "cpu")
    with pytest.raises(ValueError, match="word pair"):
        rng.random_bits(torch.zeros(3, dtype=torch.int32), (4,), "cpu")


def test_chip_smoke_vectors_are_jaxs():
    """The literal known-answer vectors ``chip_smoke.py`` holds the card
    to are jax's draws, and the port's on the CPU."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert len(chip_smoke.RNG_VECTORS) >= 10
    for case, words in chip_smoke.RNG_VECTORS:
        kind, seed, *args = case
        k = jax.random.PRNGKey(seed)
        if kind == "key":
            want = k
        elif kind == "split":
            want = jax.random.split(k, args[0])
        elif kind == "fold_in":
            want = jax.random.fold_in(k, args[0])
        elif kind == "bits":
            want = jax.random.bits(k, tuple(args[0]), jnp.uint32)
        elif kind == "uniform":
            want = jax.random.uniform(k, tuple(args[0]), minval=args[1],
                                      maxval=args[2])
        else:
            assert kind == "bernoulli"
            want = jax.random.bernoulli(k, args[0], tuple(args[1]))
        assert u32(want).reshape(-1).tolist() == words, case
        got = chip_smoke.rng_case(rng, case, "cpu")
        assert bp.to_u32(got).reshape(-1).tolist() == words, case
