"""``compile_op``: §8.1 ops compiled once, run on operands never traced.

Every op at tiers 3 and 5 runs through ``DramSession`` on the CPU, fused
and megakernel, on three fresh operand sets side by side in one image
(uniform; divisors ``u32 >> k`` with 0 and 1 among them; edge words),
against NumPy's integer arithmetic.  ``compile_elementwise`` keys rows by value: its
add, sub and mul carry to fresh operands, its div does not (a pinned
fault).  Last, the spans and counters a megakernel call leaves.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.backends import ExecutionContext
from repro_torch.compile import (CompiledOp, CompiledProgram,
                                 compile_elementwise, compile_op)
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.megakernel.plan import plan_for
from repro_torch.pud.arith import OPS
from repro_torch.session import DramSession

MODES = ("fused", "megakernel")
LAWS = ("uniform", "log_divisor", "edges")
EDGE_WORDS = sorted({0, 1, 2, 3, 5, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA,
                     *(1 << k for k in range(0, 32, 3)),
                     *((1 << k) - 1 for k in range(2, 33, 5)),
                     *((1 << k) + 1 for k in range(1, 32, 4)),
                     0x0001FFFF, 0xDEADBEEF, 0x12345678, 0xFFFF0000,
                     0x00010000, 0x7FFFFFFE, 0xFFFFFFFD, 0x40000000,
                     0xC0000000, 0x00000007, 0x0000FFFF, 0x80000002,
                     0x3FFFFFFF, 0x00FF00FF, 0xFF00FF00, 0xFFFFFFF0,
                     0x0F0F0F0F, 0xF0F0F0F0, 0x01010101, 0x10000000,
                     0x00000100, 0x00080000, 0xFFFEFFFF})


def expected(op, a, b):
    """Exact uint32 results; a divisor of 0 gives 0xFFFFFFFF."""
    a, b = a.astype(np.uint64), b.astype(np.uint64)
    if op == "div":
        q = np.where(b == 0, 0xFFFFFFFF, a // np.maximum(b, 1))
    else:
        q = {"and": a & b, "or": a | b, "xor": a ^ b, "add": a + b,
             "sub": a - b, "mul": a * b}[op]
    return (q & 0xFFFFFFFF).astype(np.uint32)


def operands(law, seed):
    """A fresh operand set of 64 words (2,048 lanes): uniform, divisors
    ``u32 >> k`` (k uniform on 0..32, so 0 is among them) with 0 and 1
    planted, or every pair of edge words."""
    n = 64 * 32
    rng = np.random.default_rng([seed, LAWS.index(law)])
    if law == "edges":
        a, b = np.meshgrid(np.asarray(EDGE_WORDS, np.uint32),
                           np.asarray(EDGE_WORDS, np.uint32))
        a, b = a.ravel(), b.ravel()
        return (np.concatenate([a, a[:n - a.size]]),
                np.concatenate([b, b[:n - b.size]]))
    a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, n, dtype=np.uint64)
    if law == "log_divisor":
        b >>= rng.integers(0, 33, n).astype(np.uint64)
        b[:64] = 0
        b[64:128] = 1
    return a, b.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _compiled(op, tier):
    """The op's CompiledOp and one session for both modes (its cache
    schedules, lowers and certifies once)."""
    ctx = ExecutionContext(device="cpu", tier=tier, n_act=32)
    return compile_op(op, tier, 32), DramSession("cuda", ctx)


def all_laws(seed):
    """The three operand sets side by side (192 words), and where each
    one's lanes lie."""
    sets = [operands(law, seed) for law in LAWS]
    a, b = (np.concatenate(x) for x in zip(*sets))
    return a, b, np.repeat(np.arange(len(LAWS)), [x.size for x, _ in sets])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", [3, 5])
@pytest.mark.parametrize("op", OPS)
def test_compiled_op_is_exact_on_fresh_operands(op, tier, mode):
    co, session = _compiled(op, tier)
    a, b, law = all_laws(seed=2**33 + tier)
    final = session.run_fused(co.program, co.image(a, b), mode=mode)
    wrong = bp.to_u32(co.outputs(final, a.size)) != expected(op, a, b)
    assert {name: int(np.count_nonzero(wrong[law == k]))
            for k, name in enumerate(LAWS)} == dict.fromkeys(LAWS, 0)


@pytest.mark.parametrize("op", OPS)
def test_program_depends_on_nothing_but_the_op(op):
    """Two compilations are one Program; its rows are the operands', the
    constants' and one SSA row a gate."""
    co = compile_op(op, 5, 32)
    again = compile_op(op, 5, 32)
    assert co.program == again.program and co.consts == again.consts
    assert co.a_rows == tuple(range(32)) and co.b_rows == tuple(range(32, 64))
    assert set(co.consts.values()) <= {0, 0xFFFFFFFF}
    assert co.n_rows == 64 + len(co.consts) + len(co.program.ops)
    dsts = [op.dsts[0] for op in co.program.ops]
    assert len(set(dsts)) == len(dsts)
    assert not set(dsts) & (set(co.a_rows) | set(co.b_rows) | set(co.consts))
    assert co.program.n_rows() <= co.n_rows


@pytest.mark.parametrize("op", OPS)
def test_histogram_is_compile_elementwise_s(op):
    a, b = operands("uniform", seed=3)
    traced = compile_elementwise(op, a[:64], b[:64], tier=5, n_act=32)
    assert compile_op(op, 5, 32).program.histogram() == \
        traced.program.histogram()


def test_image_takes_tensors_on_their_device():
    co = compile_op("add", 5, 32)
    a, b = operands("uniform", seed=4)
    image = co.image(torch.from_numpy(a.view(np.int32)),
                     torch.from_numpy(b.view(np.int32)))
    assert torch.equal(image, co.image(a, b))
    assert image.dtype == torch.int32 and image.shape == (co.n_rows, 64)
    with pytest.raises(ValueError):
        co.image(a, b[:-32])


def test_outputs_upload_the_result_rows_once():
    """Each call uploads the result rows' index once, as
    ``CompiledProgram.outputs`` does, and both unpack the same lanes."""
    co = compile_op("add", 5, 32)
    a, b = operands("uniform", seed=7)
    final = _compiled("add", 5)[1].run_fused(co.program, co.image(a, b),
                                             mode="megakernel")
    cp = CompiledProgram(co.program, bp.to_u32(co.image(a, b)),
                         co.out_rows, a.size)
    for _ in range(2):
        with obs.recording() as rec:
            got = co.outputs(final, a.size)
        assert rec.counters == {"backend.index_uploads": 1}
        assert torch.equal(cp.outputs(final), got)
    assert np.array_equal(bp.to_u32(got), expected("add", a, b))


# ------------------------------------------- compile_elementwise on new data
def retarget(cp, a, b, a_new, b_new) -> torch.Tensor:
    """``cp``'s image for new operands: the rows that hold a traced
    operand plane take the new one, uniform rows are widened, as a
    deployment that traces once would build it."""
    planes = {}
    for name, x in (("a", a), ("b", b)):
        for i, p in enumerate(bp.to_u32(bp.pack_uint_elements(
                torch.from_numpy(x.view(np.int32))))):
            planes.setdefault(p.tobytes(), (name, i))
    new = {"a": bp.pack_uint_elements(torch.from_numpy(a_new.view(np.int32))),
           "b": bp.pack_uint_elements(torch.from_numpy(b_new.view(np.int32)))}
    image = torch.zeros((cp.state.shape[0], new["a"].shape[-1]),
                        dtype=torch.int32)
    for r, row in enumerate(cp.state):
        hit = planes.get(row.tobytes())
        if hit is not None:
            image[r] = new[hit[0]][hit[1]]
        else:
            assert (row == row[0]).all(), f"row {r} is no operand plane"
            image[r] = int(row[0].view(np.int32))
    return image


@functools.lru_cache(maxsize=None)
def _traced(op):
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 2**32, 64 * 32, dtype=np.uint64)
            .astype(np.uint32) for _ in "ab")
    return compile_elementwise(op, a, b, tier=5, n_act=32), a, b


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_compile_elementwise_carries_to_fresh_operands(op, mode):
    """The premise of the benchmark's arith8 cells: a Program traced once
    is exact on every later request's operands."""
    cp, a, b = _traced(op)
    a_new, b_new, _ = all_laws(seed=11)
    session = _compiled(op, 5)[1]
    final = session.run_fused(cp.program,
                              retarget(cp, a, b, a_new, b_new), mode=mode)
    got = CompiledProgram(cp.program, cp.state, cp.out_rows,
                          a_new.size).outputs(final)
    assert np.count_nonzero(bp.to_u32(got)
                            != expected(op, a_new, b_new)) == 0


def test_compile_elementwise_div_carries_its_operands():
    """Pinned fault: value-keyed rows tie div's Program to the operands
    it was traced on (its all-zero traced planes stand for the constant
    0), so on fresh operands lanes come out wrong (in fused mode too, as
    the reference's tracer has it).  ``compile_op`` is the entry that
    does not (above)."""
    cp, a, b = _traced("div")
    a_new, b_new = operands("log_divisor", seed=11)
    # Certification passes (the Program is well formed); only the
    # results are at stake here.
    session = DramSession("cuda", ExecutionContext(
        device="cpu", tier=5, n_act=32, certify=False))
    final = session.run_fused(cp.program, retarget(cp, a, b, a_new, b_new),
                              mode="megakernel")
    got = CompiledProgram(cp.program, cp.state, cp.out_rows,
                          a_new.size).outputs(final)
    wrong = np.count_nonzero(bp.to_u32(got) != expected("div", a_new, b_new))
    assert wrong > a_new.size // 10
    traced = session.run_fused(cp.program, cp.state, mode="megakernel")
    got = CompiledProgram(cp.program, cp.state, cp.out_rows,
                          a.size).outputs(traced)
    assert np.array_equal(bp.to_u32(got), expected("div", a, b))


# ------------------------------------------------------- spans and counters
@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("op", ["add", "mul", "div"])
def test_megakernel_calls_count_levels_and_hash_once(op, calls):
    co, session = _compiled(op, 5)
    a, b = operands("uniform", seed=5)
    image = co.image(a, b)
    session.run_fused(co.program, image, mode="megakernel")
    with obs.recording() as rec:
        for _ in range(calls):
            session.run_fused(co.program, image, mode="megakernel")
    plan = plan_for(session.cache.lowering_for(co.program))
    assert rec.counters == {"megakernel.levels": calls * plan.n_levels,
                            "cache.key_hits": calls,
                            "cache.digest_hits": calls}
    for name in ("session.run_fused", "session.program_key",
                 "cache.lowering_digest"):
        assert rec.spans[name].calls == calls, name
    assert rec.spans["session.program_key"].parents == {
        "session.run_fused": calls}


@pytest.mark.parametrize("op", ["add", "sub"])
def test_fused_calls_hash_the_program_and_no_lowering(op):
    co, session = _compiled(op, 5)
    image = co.image(*operands("uniform", seed=6))
    session.run_fused(co.program, image, mode="fused")
    with obs.recording() as rec:
        session.run_fused(co.program, image, mode="fused")
    assert rec.spans["session.program_key"].calls == 1
    assert "cache.lowering_digest" not in rec.spans
    assert "megakernel.levels" not in rec.counters


def test_compile_op_is_one_span():
    with obs.recording() as rec:
        co = compile_op("sub", 5, 32)
    assert isinstance(co, CompiledOp)
    assert rec.spans["trace.compile_op"].calls == 1
    assert rec.counters == {}
