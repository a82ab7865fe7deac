"""The port's §8.1 arithmetic against the JAX package's.

Seeded numpy operands go through ``repro.pud.arith`` / ``repro.compile.
trace`` and through their ports, and everything is compared exactly:
gate values, recorded Programs (as JSON), traced images and output rows,
element results against numpy's uint32 arithmetic, and the offload
planner's PUD side.  The reference's traces of mul and div at tier 5 are
the slowest part of this file (seconds each), so each reference artifact
is computed once and shared between the tests that read it.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_u32
from repro.backends import ExecutionContext as RefContext
from repro.compile import compile_elementwise as ref_compile_elementwise
from repro.compile import trace_planes as ref_trace_planes
from repro.core import bitplanes as ref_bp
from repro.pud import offload as ref_offload
from repro.pud.arith import BitSerial as RefBitSerial
from repro.pud.arith import run_elementwise as ref_run_elementwise
from repro_torch import interop
from repro_torch.backends import ExecutionContext, get_backend
from repro_torch.compile import (build_schedule, compile_elementwise,
                                 trace_planes)
from repro_torch.compile.schedule import VALUE_KINDS
from repro_torch.core import bitplanes as bp
from repro_torch.core.costmodel import COST
from repro_torch.pud import offload
from repro_torch.pud.arith import OPS, BitSerial, run_elementwise

CPU = ExecutionContext(device="cpu", ideal=True)
TIERS = (3, 5, 7, 9)
LANES = 70          # three words, the last one ragged
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SIGN_WORDS = np.array([0x80000001, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF],
                      np.uint32)


def _t(a):
    return bp.from_u32(a, "cpu")


def _u32(x):
    return bp.to_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _operands():
    """Seeded uint32 operands with the edge lanes of every op: carry out
    of the top bit, division by zero, equal operands, sign-bit words."""
    rng = np.random.default_rng(0xA817)
    a, b = rng.integers(0, 2**32, (2, LANES), dtype=np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 1
    b[1] = 0
    b[2] = a[2]
    a[3], b[3] = 0x80000000, 0x7FFFFFFF
    b[4] = 0xFFFFFFFF
    a[5], b[5] = 0, 0
    b[6] = 3
    return a, b


A, B = _operands()


def numpy_op(op, a, b):
    """numpy's uint32 result; division by zero gives the reference's
    convention (quotient all ones)."""
    if op == "div":
        return np.where(b == 0, np.uint32(0xFFFFFFFF),
                        a // np.where(b == 0, 1, b)).astype(np.uint32)
    return {"and": np.bitwise_and, "or": np.bitwise_or,
            "xor": np.bitwise_xor, "add": np.add, "sub": np.subtract,
            "mul": np.multiply}[op](a, b).astype(np.uint32)


@functools.cache
def ref_recorded(op, tier):
    """The reference's per-gate run: (uint32 values, Program JSON)."""
    out, prog = ref_run_elementwise(op, A, B, tier=tier, n_act=32)
    return np.asarray(out), prog.to_json()


@functools.cache
def ref_compiled(op, tier):
    return ref_compile_elementwise(op, A, B, tier=tier, n_act=32)


# Reference comparisons: every tier for the cheap ops, tier 5 for mul/div.
REF_CASES = [(op, t) for op in ("and", "or", "xor", "add", "sub")
             for t in TIERS] + [("mul", 5), ("div", 5)]
REF_IDS = [f"{op}-maj{t}" for op, t in REF_CASES]


# ----------------------------------------------------------- substrate


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9, 33])
def test_word_parallel_majority_equals_majority(n):
    rng = np.random.default_rng(n)
    planes = rand_u32(rng, n, 2, 37)
    planes[:, 0, :4] = SIGN_WORDS
    planes[:, 1, 0] = 0x80000000 if n % 2 else 0xFFFFFFFF
    got = bp.majority_words(_t(planes))
    assert torch.equal(got, bp.majority(_t(planes)))
    assert (bp.to_u32(got) == np.asarray(ref_bp.majority(planes))).all()
    assert torch.equal(bp.majority_words(_t(planes).movedim(0, 2), axis=2),
                       got)
    if n == 3:
        assert torch.equal(bp.maj3_words(*_t(planes)), got)
        assert (bp.to_u32(bp.maj3_words(*_t(planes))) ==
                np.asarray(ref_bp.maj3_words(*planes))).all()


def test_word_parallel_majority_of_nothing_is_zero():
    assert torch.equal(bp.majority_words(torch.zeros((0, 5),
                                                     dtype=torch.int32)),
                       bp.majority(torch.zeros((0, 5), dtype=torch.int32)))


# --------------------------------------------------------------- gates


def _gate_calls(tier):
    calls = [("and_", 2), ("and_", 4), ("or_", 2), ("or_", 5), ("xor", 2),
             ("mux", 3), ("full_adder", 3)]
    if tier >= 7:
        calls.append(("carry_skip2", 5))
    return calls


@pytest.mark.parametrize("tier", TIERS)
def test_bitserial_gates_match_reference(tier):
    rng = np.random.default_rng(tier)
    planes = rand_u32(rng, 5, 9)
    planes[:, 0] = SIGN_WORDS[rng.integers(0, 4, 5)]
    port, ref = BitSerial(tier=tier, n_act=8), RefBitSerial(tier=tier,
                                                             n_act=8)
    for name, k in _gate_calls(tier):
        got = getattr(port, name)(*_t(planes[:k]))
        want = getattr(ref, name)(*jnp.asarray(planes[:k]))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert (bp.to_u32(g) == np.asarray(w)).all(), name
    assert port.program.to_json() == ref.program.to_json()


def test_bitserial_refuses_what_the_reference_refuses():
    bs = BitSerial(tier=5)
    p = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="odd"):
        bs.maj(p, p)
    with pytest.raises(ValueError, match="exceeds tier 5"):
        bs.maj(*[p] * 7)
    with pytest.raises(ValueError, match="tier"):
        BitSerial(tier=4)
    with pytest.raises(ValueError, match="unknown op"):
        run_elementwise("nand", A, B)


# ------------------------------------------------------ element results


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op", OPS)
def test_run_elementwise_is_exact(op, tier):
    out, prog = run_elementwise(op, A, B, tier=tier, n_act=32)
    assert out.dtype == torch.int32 and out.shape == (LANES,)
    assert (bp.to_u32(out) == numpy_op(op, A, B)).all()
    assert prog.ops and all(not o.dsts for o in prog.ops)  # cost-only


@pytest.mark.parametrize("op,tier", REF_CASES, ids=REF_IDS)
def test_recorded_program_matches_reference(op, tier):
    out, prog = run_elementwise(op, A, B, tier=tier, n_act=32)
    want, want_json = ref_recorded(op, tier)
    assert (bp.to_u32(out) == want).all()
    assert prog.to_json() == want_json


@pytest.mark.parametrize("op,tier", REF_CASES, ids=REF_IDS)
def test_compile_elementwise_matches_reference(op, tier):
    cp = compile_elementwise(op, A, B, tier=tier, n_act=32)
    ref = ref_compiled(op, tier)
    assert cp.program.to_json() == ref.program.to_json()
    assert cp.state.dtype == np.uint32 and (cp.state == ref.state).all()
    assert cp.out_rows == ref.out_rows and cp.n_lanes == ref.n_lanes
    # The traced tensor operands give the same trace as numpy ones.
    again = compile_elementwise(op, _t(A), _t(B), tier=tier, n_act=32)
    assert again.program.to_json() == cp.program.to_json()


@pytest.mark.parametrize("op", OPS)
def test_fused_elementwise_on_the_cuda_backend_is_exact(op):
    """The batch-native path: traced, then level-fused on ``cuda``
    (CPU route), with the schedule's dispatch count."""
    be = get_backend("cuda", CPU)
    with be.count_dispatches() as scope:
        out, prog = be.elementwise(op, A, B, tier=5, n_act=32)
    assert (bp.to_u32(out) == numpy_op(op, A, B)).all()
    assert scope.count == build_schedule(prog).n_dispatches()
    assert all(o.dsts for o in prog.ops)  # addressed


def test_gate_hooks_execute_the_per_gate_path():
    """A non-batch executor computes every recorded gate itself."""
    oracle = get_backend("oracle", CPU)
    out, prog = oracle.elementwise("add", A, B, tier=7, n_act=32)
    assert (bp.to_u32(out) == numpy_op("add", A, B)).all()
    assert prog.to_json() == ref_recorded("add", 7)[1]
    p = _t(rand_u32(np.random.default_rng(9), 3, 4))
    assert torch.equal(oracle.gate_maj(list(p), 3, 4), bp.majority(p))
    assert torch.equal(oracle.gate_not(p[0]), ~p[0])


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_adder_goldens_retrace(nbits):
    """``tests/golden/generate.py``'s ``_adder`` seeds, traced by the
    port, give the frozen Programs and the reference's image."""
    doc = _golden(f"add{nbits}")
    rng = np.random.default_rng(nbits)
    bits = [rng.integers(0, 2, (nbits, doc["words"] * 32)).astype(bool)
            for _ in range(2)]
    cp = trace_planes(lambda bs: list(bs.add(*(bp.pack(torch.from_numpy(
        x)) for x in bits))[0]), tier=5, n_act=32)
    assert json.loads(cp.program.to_json()) == doc["ops"]
    assert cp.state.shape == (doc["rows"], doc["words"])
    ref = ref_trace_planes(lambda bs: list(bs.add(*(ref_bp.pack(x)
                                                    for x in bits))[0]),
                           tier=5, n_act=32)
    assert (cp.state == ref.state).all() and cp.out_rows == ref.out_rows


def test_compiled_program_carried_across():
    ref = ref_compiled("sub", 5)
    cp = interop.compiled_program_from(ref.program.to_json(), ref.state,
                                       ref.out_rows, ref.n_lanes)
    final = get_backend("cuda", CPU).run_fused(cp.program, cp.state,
                                               mode="megakernel")
    assert (bp.to_u32(cp.outputs(final)) == numpy_op("sub", A, B)).all()
    assert (bp.to_u32(cp.outputs(bp.to_u32(final)))
            == numpy_op("sub", A, B)).all()
    with pytest.raises(ValueError, match="outside"):
        interop.compiled_program_from(ref.program.to_json(), ref.state,
                                      (len(ref.state),), ref.n_lanes)
    with pytest.raises(ValueError, match="rows, words"):
        interop.compiled_program_from(ref.program.to_json(),
                                      ref.state[0], (0,), ref.n_lanes)


# ------------------------------------------------------------- offload


CTXS = [(ExecutionContext(), RefContext()),
        (ExecutionContext(mfr="M", temp_c=80.0, vpp_v=2.3),
         RefContext(mfr="M", temp_c=80.0, vpp_v=2.3))]


@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("ctxs", CTXS, ids=["H", "M-hot-lowvpp"])
def test_plan_program_pud_side_matches_reference(op, ctxs):
    ctx, ref_ctx = ctxs
    ref_prog = ref_compiled(op, 5).program
    prog = interop.program_from_json(ref_prog.to_json())
    row_bytes = 2**18 * 4
    d = offload.plan_program(prog, row_bytes, ctx=ctx)
    r = ref_offload.plan_program(ref_prog, row_bytes, ctx=ref_ctx)
    assert (d.pud_ns, d.pud_energy_nj, d.op) == (r.pud_ns, r.pud_energy_nj,
                                                 r.op)
    sched = build_schedule(prog)
    rows = sum(len(o.srcs) + len(o.dsts) for o in prog.ops
               if o.dsts and o.kind in VALUE_KINDS)
    assert d.gpu_ns == (COST.dispatch_overhead(sched.n_dispatches())
                        + COST.hbm_ns(rows * row_bytes))
    assert d.gpu_energy_nj == (COST.dispatch_energy_nj(sched.n_dispatches())
                               + COST.hbm_energy_nj(rows * row_bytes))
    assert d.winner == ("pud" if d.pud_ns < d.gpu_ns else "gpu")
    assert d.winner_energy == ("pud" if d.pud_energy_nj < d.gpu_energy_nj
                               else "gpu")
    assert d.speedup == d.gpu_ns / d.pud_ns
    assert offload.gpu_program_ns(prog, row_bytes, fused=False) == (
        COST.dispatch_overhead(sched.per_op_dispatches())
        + COST.hbm_ns(rows * row_bytes))


@pytest.mark.parametrize("x", [3, 5, 9])
@pytest.mark.parametrize("ctxs", CTXS, ids=["H", "M-hot-lowvpp"])
def test_plan_vote_and_broadcast_pud_side_match_reference(x, ctxs):
    ctx, ref_ctx = ctxs
    n = 3 * 2**20 + 17
    d, r = offload.plan_vote(n, x, ctx=ctx), ref_offload.plan_vote(
        n, x, ctx=ref_ctx)
    assert (d.pud_ns, d.pud_energy_nj) == (r.pud_ns, r.pud_energy_nj)
    assert d.gpu_ns == offload.gpu_bitwise_ns(n, x) == \
        n * (x + 1) / COST.hbm_bytes_per_s * 1e9
    assert d.gpu_energy_nj == COST.hbm_energy_nj(n * (x + 1))
    fan = 4 * x
    d = offload.plan_broadcast(n, fan, ctx=ctx)
    r = ref_offload.plan_broadcast(n, fan, ctx=ref_ctx)
    assert (d.pud_ns, d.pud_energy_nj) == (r.pud_ns, r.pud_energy_nj)
    assert d.gpu_ns == COST.hbm_ns(n * (1 + fan))
    for best in (True, False):
        assert offload.pud_majx_ns(n, x, 16, best_group=best, ctx=ctx) == \
            ref_offload.pud_majx_ns(n, x, 16, best_group=best, ctx=ref_ctx)
    assert offload.pud_mrc_energy_nj(n, fan, ctx=ctx) == \
        ref_offload.pud_mrc_energy_nj(n, fan, ctx=ref_ctx)
