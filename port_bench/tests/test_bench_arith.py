"""The arith driver's image assembly against ``compile_elementwise``, and
the plain reference of the §8.1 ops."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench.tests._util import SEED, cells_of
from port_bench.harness.spec import load_cell, load_file_module, BENCH_DIR

arith = load_file_module(BENCH_DIR / "drivers" / "arith.py",
                         "drivers.arith")
ref = load_file_module(BENCH_DIR / "reference" / "arith.py",
                       "reference.arith")
CONFIG = load_cell(cells_of("arith")[0]).config


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("words", [64, 96])
def test_template_is_the_traced_image_at_another_width(op, words):
    from repro_torch.compile.trace import compile_elementwise
    from repro_torch.core import bitplanes as bp
    from repro_torch.session.cache import program_key

    prog = arith.trace_op(op, CONFIG)           # traced at 64 words
    rng = np.random.default_rng(words + 7)
    a = rng.integers(0, 2**32, words * 32, dtype=np.uint32)
    b = rng.integers(0, 2**32, words * 32, dtype=np.uint32)
    cp = compile_elementwise(op, a, b, tier=CONFIG["tier"],
                             n_act=CONFIG["n_act"])
    assert program_key(cp.program) == program_key(prog.compiled.program)
    assert cp.out_rows == prog.compiled.out_rows
    image = arith.template(prog, words, "cpu")
    for rows, x in ((prog.a_rows, a), (prog.b_rows, b)):
        planes = bp.pack_uint_elements(torch.from_numpy(x.view(np.int32)))
        image.index_copy_(0, torch.as_tensor(rows), planes)
    assert np.array_equal(bp.to_u32(image), cp.state)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_reference_against_python_ints(op):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    py = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y}[op]
    want = np.asarray([py(int(x), int(y)) % 2**32 for x, y in zip(a, b)],
                      np.uint32)
    assert np.array_equal(ref.expected(op, a, b), want)
    assert ref.wrong_lanes(op, a, b, want) == 0
    bad = want.copy()
    bad[5] ^= 1
    assert ref.wrong_lanes(op, a, b, bad) == 1
    assert ref.wrong_lanes(op, a, b, want[:10]) == 1000
    assert ref.wrong_lanes(op, a, b, ref.control(op, a, b)) > 900


def test_operands_are_drawn_again_from_the_seed():
    st = arith.State(dict(CONFIG, bank_words=4, banks=1),
                     load_cell(cells_of("arith")[0]).traffic, SEED, "cpu")
    a1, b1 = st.operands(7)
    a2, b2 = st.operands(7)
    a3, _ = st.operands(8)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3) and not torch.equal(a1, b1)
