"""The plain reference of the integrity service on hand-made tiles, and
the pool the serve driver makes from the seed."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench.tests._util import SEED, cells_of, spec_and_shelved
from port_bench.harness.spec import BENCH_DIR, load_cell, load_file_module

ref = load_file_module(BENCH_DIR / "reference" / "serve.py",
                       "reference.serve")
serve = load_file_module(BENCH_DIR / "drivers" / "serve.py",
                         "drivers.serve")
TRAFFIC = load_cell(cells_of("serve")[0], spec_and_shelved()).traffic


def test_popcount():
    words = np.asarray([0, 1, 0xFFFFFFFF, 0x80000001, 0xF0F0F0F0],
                       np.uint32)
    assert ref.popcount(words) == 0 + 1 + 32 + 2 + 16
    assert ref.popcount(words[:0]) == 0


@pytest.mark.parametrize("x", [3, 5])
def test_heal_is_the_bitwise_majority(x):
    clean = np.asarray([[0x12345678, 0xFFFFFFFF], [0, 0xDEADBEEF]],
                       np.uint32)
    reps = np.stack([clean] * x)
    reps[0, 0, 0] ^= 0x0000000F        # 4 bits wrong in replica 0
    reps[1, 1, 1] ^= 0x80000000        # 1 bit wrong in replica 1
    assert np.array_equal(ref.heal(reps), clean)
    assert ref.fixed_bits(reps) == 4
    tile, fixed = ref.control_heal(reps)
    assert fixed == 0 and ref.tile_bits_wrong(clean, tile) == 4


def test_erase_and_verify():
    want = ref.erase(2, 3, 0xDEADBEEF)
    assert want.shape == (2, 3) and (want == 0xDEADBEEF).all()
    got = want.copy()
    got[1, 2] = 0
    assert ref.words_wrong(want, got) == 1
    assert ref.words_wrong(want, got[:1]) == 6
    live = np.asarray([[1, 2], [3, 4]], np.uint32)
    assert ref.verify(live, live) == 0
    assert ref.verify(live, live ^ np.uint32(3)) == 8
    assert ref.tile_bits_wrong(live, live[:1]) == 4 * 32


def test_pool_from_the_seed():
    pool = serve.make_pool(TRAFFIC, 8, SEED, "cpu")
    again = serve.make_pool(TRAFFIC, 8, SEED, "cpu")
    assert len(pool["heal"]) == TRAFFIC["pool"]["heal"]
    assert pool["verify"] == []
    for j, reps in enumerate(pool["heal"]):
        assert reps.shape == (3, 8, 8) and reps.dtype == np.uint32
        assert np.array_equal(reps, again["heal"][j])
        # One word of replica j % 3 XORed with 0b101, as serve_bench does.
        bad = [ref.popcount(reps[k] ^ ref.heal(reps)) for k in range(3)]
        assert bad == [2 if k == j % 3 else 0 for k in range(3)]
        words = np.flatnonzero(reps[j % 3] != reps[(j + 1) % 3])
        assert len(words) == 1
        assert (reps[j % 3] ^ reps[(j + 1) % 3]).reshape(-1)[words[0]] == 5


def test_verify_pool_from_the_seed():
    traffic = dict(TRAFFIC, pool={"heal": 0, "verify": 32},
                   verify_flips=[1, 46], verify_span=16)
    pool = serve.make_pool(traffic, 8, SEED, "cpu")
    assert pool["heal"] == [] and len(pool["verify"]) == 32
    counts = sorted({ref.verify(*p) for p in pool["verify"]})
    assert counts == list(range(1, 47, 3))
