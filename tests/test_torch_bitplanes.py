"""The port's bit-plane substrate against the JAX reference.

Packed words are int32 tensors in the port and uint32 arrays in the
reference; every comparison converts at the one boundary
(``from_u32``/``to_u32``) and is bit-exact.  Words with the sign bit set
(``0x80000001``, ``0xFFFFFFFF``) pin the int32 hazard: a right shift
that forgot its mask would sign-extend them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_bits, rand_u32, sweep
from repro.core import bitplanes as ref
from repro_torch.core import bitplanes as bp

WORD_EDGES = (1, 31, 32, 33, 1024)
SIGN_WORDS = np.array([0x80000001, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0,
                       1], np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return bp.from_u32(a, "cpu")


def test_boundary_helpers_keep_bits():
    t = _t(SIGN_WORDS)
    assert t.dtype == torch.int32
    assert (bp.to_u32(t) == SIGN_WORDS).all()
    assert (bp.to_u32(t >> 1 & 0x7FFFFFFF)
            == SIGN_WORDS >> np.uint32(1)).all()


@pytest.mark.parametrize("n_bits", WORD_EDGES)
def test_pack_unpack_word_boundary(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rand_bits(rng, 2, n_bits)
    words = bp.pack(torch.from_numpy(bits))
    assert (bp.to_u32(words) == np.asarray(ref.pack(bits))).all()
    assert (bp.unpack(words, n_bits).numpy() == bits).all()
    full = bp.n_words(n_bits) * 32
    assert (bp.unpack(words, full).numpy()
            == np.asarray(ref.unpack(ref.pack(bits), full))).all()


@pytest.mark.parametrize("n_bits", WORD_EDGES)
def test_unpack_sign_bit_words(n_bits):
    words = np.resize(SIGN_WORDS, (3, bp.n_words(n_bits)))
    assert (bp.unpack(_t(words), n_bits).numpy()
            == np.asarray(ref.unpack(jnp.asarray(words), n_bits))).all()


@sweep(n_cases=6, seed=0xB17)
def test_popcount_matches_reference(rng):
    words = np.concatenate([rand_u32(rng, 50), SIGN_WORDS])
    got = bp.popcount(_t(words))
    assert got.dtype == torch.int32
    assert (got.numpy() == np.asarray(ref.popcount(words))).all()


@pytest.mark.parametrize("n", [1, 3, 5, 9, 33])
def test_majority_matches_reference(n):
    rng = np.random.default_rng(n)
    planes = rand_u32(rng, n, 3, 17)
    planes[:, 0, 0] = 0x80000001  # every plane votes the sign bit in
    got = bp.to_u32(bp.majority(_t(planes)))
    assert (got == np.asarray(ref.majority(planes))).all()


@pytest.mark.parametrize("k", WORD_EDGES)
def test_pack_uint_elements_word_boundary(k):
    rng = np.random.default_rng(k)
    x = rand_u32(rng, 2, k)
    x[0, 0] = 0xFFFFFFFF
    planes = bp.pack_uint_elements(_t(x))
    assert (bp.to_u32(planes)
            == np.asarray(ref.pack_uint_elements(jnp.asarray(x)))).all()
    assert (bp.to_u32(bp.unpack_uint_elements(planes, k)) == x).all()


@pytest.mark.parametrize("n_bits", WORD_EDGES)
def test_pack_uint_elements_narrow_width(n_bits):
    width = min(n_bits, 32)
    rng = np.random.default_rng(n_bits + 7)
    x = rng.integers(0, 2**width, size=(40,), dtype=np.uint64) \
        .astype(np.uint32)
    planes = bp.pack_uint_elements(_t(x), n_bits=width)
    want = ref.pack_uint_elements(jnp.asarray(x), n_bits=width)
    assert (bp.to_u32(planes) == np.asarray(want)).all()
    assert (bp.to_u32(bp.unpack_uint_elements(planes, 40)) == x).all()


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16",
                                   "float16", "int8", "uint8"])
@pytest.mark.parametrize("n_elem", [1, 33])
def test_bitcast_planes_match_reference(dtype, n_elem):
    rng = np.random.default_rng(n_elem)
    raw = rng.integers(0, 256, n_elem * 4, dtype=np.uint8)
    tdtype = getattr(torch, dtype)
    x = torch.from_numpy(raw).view(tdtype)[:n_elem].reshape(n_elem)
    words, shape, got_dtype = bp.bitcast_to_planes(x)
    jx = jnp.asarray(raw).view(jnp.dtype(dtype))[:n_elem]
    want, _, _ = ref.bitcast_to_planes(jx)
    assert (bp.to_u32(words) == np.asarray(want)).all()
    back = bp.bitcast_from_planes(words, shape, got_dtype)
    assert back.dtype == tdtype and torch.equal(back.view(torch.uint8),
                                                x.view(torch.uint8))
