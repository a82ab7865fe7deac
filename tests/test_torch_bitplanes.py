"""The port's bit-plane substrate against the JAX reference.

Packed words are int32 tensors in the port and uint32 arrays in the
reference; every comparison converts at the one boundary
(``from_u32``/``to_u32``) and is bit-exact.  Words with the sign bit set
(``0x80000001``, ``0xFFFFFFFF``) pin the int32 hazard: a right shift
that forgot its mask would sign-extend them.
"""

import functools

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


#: Weight vectors for :func:`weighted_majority`: odd totals, even totals
#: with ties, zero, negative and single weights.
WEIGHTS = ((2, 2, 1), (2, 2, 1, 1, 1), (1, 1, 1, 1), (1, 2, 3, 4), (1, 1),
           (3, -1, 2), (0, 0, 0), (-2, 1, 1), (7,), (1, 1, 1, 1, 1, 1, 1))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
def test_weighted_majority_matches_reference(weights, axis):
    rng = np.random.default_rng([len(weights), sum(weights) + 8, axis])
    planes = rand_u32(rng, len(weights), 4, 9)
    planes[:, 0, 0] = 0x80000001  # every plane votes the sign bit in
    if axis:
        planes = np.moveaxis(planes, 0, axis).copy()
    got = bp.weighted_majority(_t(planes), weights, axis=axis)
    want = ref.weighted_majority(jnp.asarray(planes), jnp.asarray(weights),
                                 axis=axis)
    assert got.dtype == torch.int32 and got.device == torch.device("cpu")
    assert (bp.to_u32(got) == np.asarray(want)).all()


@sweep(n_cases=6, seed=0x2A1)
def test_weighted_majority_identities(rng):
    """MAJ3(x, y, z) is the weighted majority (2, 2, 1) of (x, y, z), and
    §8.1's two-position carry c2 = MAJ7(a1,a1,b1,b1,a0,b0,c0) is the
    weighted majority (2, 2, 1, 1, 1) of (a1, b1, a0, b0, c0): the carry
    out of the 2-bit sum (2 a1 + a0) + (2 b1 + b0) + c0, lane by lane."""
    x, y, z = (_t(rand_u32(rng, 16)) for _ in range(3))
    assert torch.equal(bp.weighted_majority(torch.stack([x, y, z]),
                                            (2, 2, 1)),
                       bp.maj3_words(x, y, z))
    a1, b1, a0, b0, c0 = (rand_u32(rng, 16) for _ in range(5))
    c2 = bp.to_u32(bp.weighted_majority(
        _t(np.stack([a1, b1, a0, b0, c0])), (2, 2, 1, 1, 1)))
    assert (c2 == bp.to_u32(bp.majority(
        _t(np.stack([a1, a1, b1, b1, a0, b0, c0]))))).all()
    lanes = [np.unpackbits(w.view(np.uint8), bitorder="little").astype(int)
             for w in (a1, b1, a0, b0, c0)]
    total = 2 * lanes[0] + lanes[2] + 2 * lanes[1] + lanes[3] + lanes[4]
    assert (np.unpackbits(c2.view(np.uint8), bitorder="little")
            == (total >= 4)).all()


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


@functools.lru_cache(maxsize=None)
def _wide_case(k: int, lead: tuple):
    """Elements of shape (*lead, k) with sign-bit words first, and the
    reference's 40 planes of them and its unpack of those: a narrower
    pack is their first ``n_bits`` planes.  Cached, since each new shape
    costs the reference a trace."""
    rng = np.random.default_rng([k, len(lead)])
    x = rand_u32(rng, *lead, k)
    x.reshape(-1)[:len(SIGN_WORDS)] = SIGN_WORDS[:k]
    planes = ref.pack_uint_elements(jnp.asarray(x), n_bits=40)
    return x, np.asarray(planes), np.asarray(
        ref.unpack_uint_elements(planes, k))


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=str)
@pytest.mark.parametrize("n_bits", [1, 5, 31, 32, 33, 40])
@pytest.mark.parametrize("k", [1, 31, 33, 1000])
def test_pack_uint_elements_shapes_match_reference(k, n_bits, lead):
    """Ragged k, any width from 1 to 40 planes (zero planes past the
    32nd), leading batch dimensions and sign-bit words: the CPU route
    equals the reference, and unpacking gives back the low ``n_bits``
    bits of every element (all of them from 32 planes on, as the
    reference's unpack does)."""
    x, want, want_back = _wide_case(k, lead)
    planes = bp.pack_uint_elements(_t(x), n_bits=n_bits)
    assert planes.shape == (*lead, n_bits, bp.n_words(k))
    assert (bp.to_u32(planes) == want[..., :n_bits, :]).all()
    back = bp.unpack_uint_elements(planes, k)
    low = np.uint32(0xFFFFFFFF >> max(0, 32 - n_bits))
    assert back.shape == (*lead, k)
    assert (bp.to_u32(back) == (x & low)).all()
    if n_bits >= 32:
        assert (bp.to_u32(back) == want_back).all()


@pytest.mark.parametrize("n_planes", [0, 5, 32, 40])
def test_unpack_uint_elements_plane_count_matches_reference(n_planes):
    """Fewer than 32 planes read the missing bits as zero (none at all:
    every element 0, where the reference's reshape fails); planes past
    the 32nd are ignored; k may be less than the planes' 32 * words."""
    rng = np.random.default_rng(n_planes)
    planes = rand_u32(rng, 2, n_planes, 40)
    for k in (1000, 1280):
        got = bp.unpack_uint_elements(_t(planes), k)
        want = (np.asarray(ref.unpack_uint_elements(jnp.asarray(planes), k))
                if n_planes else np.zeros((2, k), np.uint32))
        assert (bp.to_u32(got) == want).all()


def test_pack_uint_elements_int64_and_strided_input():
    """int64 values are taken modulo 2**32 (negative ones too); a
    non-contiguous view packs as its contiguous copy does."""
    rng = np.random.default_rng(64)
    x = rng.integers(-2**40, 2**40, (3, 1000), dtype=np.int64)
    got = bp.pack_uint_elements(torch.from_numpy(x))
    want = ref.pack_uint_elements(jnp.asarray(x.astype(np.uint32)))
    assert (bp.to_u32(got) == np.asarray(want)).all()
    wide = _t(rand_u32(rng, 1000, 3)).T
    assert not wide.is_contiguous()
    assert torch.equal(bp.pack_uint_elements(wide, 33),
                       bp.pack_uint_elements(wide.contiguous(), 33))
    planes = bp.pack_uint_elements(wide.contiguous())
    strided = planes.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not strided.is_contiguous()
    assert torch.equal(bp.unpack_uint_elements(strided, 1000), wide)
