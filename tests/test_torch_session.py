"""The port's session layer against the reference package's.

Every case runs the same script through ``repro.session`` (on the
``pallas`` backend in interpret mode, or ``oracle``) and through
``repro_torch.session`` (on ``cuda`` with ``ExecutionContext(device=
"cpu")``, where every kernel wrapper takes its plain version), and
compares what a user of either sees: results bit for bit, dispatch
counts, the three cache windows, program keys, built programs and
images, error types and messages, and the §8.1 ``elementwise`` path.
Nothing here needs ``sim``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_u32
from repro.backends import ExecutionContext as RefContext
from repro.pud.isa import Program as RefProgram
from repro.session import CompileCache as RefCache
from repro.session import DramSession as RefSession
from repro.session import PlaneGroup as RefPlaneGroup
from repro.session import program_key as ref_program_key
from repro.session.rows import RowAllocator as RefRowAllocator
from repro_torch import interop
from repro_torch.backends import ExecutionContext
from repro_torch.core import bitplanes as bp
from repro_torch.pud.isa import Program
from repro_torch.session import (CompileCache, DramSession, PlaneGroup,
                                 ProgramValidationError, program_key)
from repro_torch.session.rows import RowAllocator
from test_compile_differential import ROWS, WORDS, rand_program

CPU = ExecutionContext(device="cpu", ideal=True)
REF = RefContext(ideal=True)


def _port(ref_prog):
    return interop.program_from_json(ref_prog.to_json())


def _valid(ref_prog):
    """The reference's random program with per-op duplicate destinations
    removed (they fail validation); aliasing, rewrites, dead stores and
    cost-only ops stay."""
    out = RefProgram()
    for op in ref_prog.ops:
        out.emit(op.kind, x=op.x, n_act=op.n_act, tag=op.tag,
                 srcs=op.srcs, dsts=tuple(dict.fromkeys(op.dsts)))
    return out


def _u32(x):
    return bp.to_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats(cache):
    return tuple((s.hits, s.misses) for s in (
        cache.stats, cache.lowering_stats, cache.certificate_stats))


def _cases(n=12, seed=0x5E55):
    rng = np.random.default_rng(seed)
    return [(_valid(rand_program(rng, n_ops=int(rng.integers(6, 14)))),
             rand_u32(rng, ROWS, WORDS)) for _ in range(n)]


def _outcome(fn):
    """``fn()``'s result, or (error class name, message) if it raises."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


# ------------------------------------------------------ program execution


@pytest.mark.parametrize("case", _cases(), ids=[f"rand{i}" for i in
                                                range(12)])
def test_session_runs_match_pallas_session(case):
    ref_prog, state = case
    prog = _port(ref_prog)
    ref = RefSession("pallas", REF)
    sess = DramSession("cuda", CPU)
    for run in ("run", "fused", "megakernel", "megakernel", "fused"):
        with ref.count_dispatches() as ref_scope:
            want = _outcome(lambda: ref.run(ref_prog, jnp.asarray(state))
                            if run == "run" else ref.run_fused(
                                ref_prog, jnp.asarray(state), mode=run))
        with sess.count_dispatches() as scope:
            got = _outcome(lambda: sess.run(prog, state) if run == "run"
                           else sess.run_fused(prog, state, mode=run))
        if isinstance(want, tuple):    # both refuse, alike (see below)
            assert got == want, run
        else:
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            assert (_u32(got) == _u32(want)).all(), run
        assert scope.count == ref_scope.count, run
        assert _stats(sess.cache) == _stats(ref.cache), run
    cert = sess.cache.certificate_for(prog)
    ref_cert = ref.cache.certificate_for(ref_prog)
    assert cert.to_dict() == ref_cert.to_dict()
    assert _stats(sess.cache) == _stats(ref.cache)


def test_frac_on_the_top_row_fails_megakernel_certification():
    """A fault of the reference, kept by the port's copy: a program whose
    highest row is touched only by a value-neutral op (FRAC) has one
    more row than its megakernel lowering, and the equivalence pass
    reports EQ_TABLE_SHAPE, so a valid program cannot run in megakernel
    mode with certification on.  Both packages refuse it alike."""
    progs = []
    for cls in (RefProgram, Program):
        p = cls()
        p.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
        p.emit("FRAC", dsts=(4,))
        progs.append(p)
    state = np.zeros((5, 4), np.uint32)
    ref = RefSession("pallas", REF)
    sess = DramSession("cuda", CPU)
    want = _outcome(lambda: ref.run_fused(progs[0], jnp.asarray(state),
                                          mode="megakernel"))
    got = _outcome(lambda: sess.run_fused(progs[1], state,
                                          mode="megakernel"))
    assert got == want and got[0] == "CertificationError"
    assert "EQ_TABLE_SHAPE" in got[1]
    assert (bp.to_u32(sess.run_fused(progs[1], state)) == state).all()


def test_cache_windows_match_reference():
    """One script of lookups (repeat, tag-only twin, shared cache,
    eviction, megakernel upgrade) moves all three windows alike."""
    rng = np.random.default_rng(1)
    progs = [_valid(rand_program(rng, n_ops=10)) for _ in range(3)]
    twin = RefProgram()
    for op in progs[0].ops:
        twin.emit(op.kind, x=op.x, n_act=op.n_act, tag=op.tag + "/twin",
                  srcs=op.srcs, dsts=op.dsts)
    state = rand_u32(rng, ROWS, WORDS)
    script = [(0, "fused", 0), (0, "fused", 0), (1, "megakernel", 0),
              (3, "fused", 1), (0, "megakernel", 1), (2, "fused", 1),
              (1, "fused", 0), (0, "megakernel", 0), (2, "megakernel", 1)]
    all_progs = [*progs, twin]
    ref_cache, cache = RefCache(maxsize=2), CompileCache(maxsize=2)
    for i, mode, which in script:
        ref = RefSession("pallas", REF, cache=ref_cache, name=f"s{which}")
        sess = DramSession("cuda", CPU, cache=cache, name=f"s{which}")
        want = ref.run_fused(all_progs[i], jnp.asarray(state), mode=mode)
        got = sess.run_fused(_port(all_progs[i]), state, mode=mode)
        assert (_u32(got) == _u32(want)).all()
        assert _stats(cache) == _stats(ref_cache), (i, mode)
        assert len(cache) == len(ref_cache)


@pytest.mark.parametrize("seed", range(4))
def test_program_keys_equal(seed):
    rng = np.random.default_rng(seed)
    ref_prog = rand_program(rng, n_ops=14)
    assert program_key(_port(ref_prog)) == ref_program_key(ref_prog)


def test_program_key_ignores_tags_only():
    a, b, c = Program(), Program(), Program()
    a.emit("MAJ", x=3, n_act=4, tag="left", srcs=(0, 1, 2), dsts=(3,))
    b.emit("MAJ", x=3, n_act=4, tag="right", srcs=(0, 1, 2), dsts=(3,))
    c.emit("MAJ", x=3, n_act=4, tag="left", srcs=(0, 1, 2), dsts=(4,))
    assert program_key(a) == program_key(b)
    assert program_key(a) != program_key(c)
    ref = RefProgram.from_json(a.to_json())
    assert ref_program_key(ref) == program_key(a)


def test_success_rate_and_mismatch_match_reference():
    rng = np.random.default_rng(8)
    got, want = rand_u32(rng, 6, 64), rand_u32(rng, 6, 64)
    want[:3] = got[:3]
    got[0, 0] = 0xFFFFFFFF
    ref = RefSession("pallas", REF)
    sess = DramSession("cuda", CPU)
    with sess.count_dispatches() as scope:
        count = sess.mismatch(got, want)
    assert scope.count == 1
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(ref.mismatch(jnp.asarray(got),
                                          jnp.asarray(want)))
    assert sess.success_rate(got, want) == ref.success_rate(
        jnp.asarray(got), jnp.asarray(want))
    assert sess.success_rate(got, want, n_bits=10_000) == \
        ref.success_rate(jnp.asarray(got), jnp.asarray(want),
                         n_bits=10_000)
    assert sess.success_rate(got, got) == 1.0


def test_heal_vote_through_the_builder():
    """A small serve-style heal batch: three replicas with disjoint
    flips vote back to the clean rows, and mismatch counts the flips."""
    rng = np.random.default_rng(12)
    clean = rand_u32(rng, 4, 32)
    reps = [clean.copy() for _ in range(3)]
    for j, rep in enumerate(reps):
        rep[j, 5 + j] ^= np.uint32(1 << (3 * j + 1))
    outs = []
    for sess_cls, ctx in ((RefSession, REF), (DramSession, CPU)):
        sess = sess_cls("pallas" if sess_cls is RefSession else "cuda", ctx)
        b = sess.program(rows=16, name="heal")
        groups = [b.input(r, tag=f"replica[{j}]")
                  for j, r in enumerate(reps)]
        voted = b.alloc_rows(4, tag="voted")
        for r in range(4):
            b.maj(*(g[r] for g in groups), dst=voted[r], n_act=32,
                  tag=f"row[{r}]")
        final = _u32(sess.run_fused(b.build(), b.initial_state()))
        tile = final[list(voted.indices)]
        outs.append((b.program.to_json(), tile,
                     int(sess.mismatch(reps[0], tile)),
                     sess.success_rate(reps[0], tile)))
    assert outs[0][0] == outs[1][0]
    assert (outs[1][1] == clean).all() and (outs[0][1] == clean).all()
    assert outs[0][2:] == outs[1][2:] == (1, 1 - 1 / (4 * 32 * 32))


# ------------------------------------------------------ typed construction


def _build(sess, group_cls):
    rng = np.random.default_rng(2)
    b = sess.program(rows=16, name="typed-demo")
    scratch = b.alloc_rows(2, tag="scratch")
    ins = b.input(rand_u32(rng, 5, 8))
    one = b.input(rand_u32(rng, 8), tag="one")
    vote = b.maj(*list(ins), tag="vote")
    rep = b.maj(ins[0], ins[1], one, one, one, tag="replicated")
    inv = b.not_(vote, tag="inv")
    b.copy(rep, dst=scratch[0])
    fan = b.mrc(inv, 4, tag="fan")
    b.mrc(one, group_cls((scratch[1],)), tag="one-row")
    return b, fan


def test_builder_programs_and_images_match_reference():
    ref_b, ref_fan = _build(RefSession("oracle", REF), RefPlaneGroup)
    b, fan = _build(DramSession("cuda", CPU), PlaneGroup)
    prog, ref_prog = b.build(), ref_b.build()
    assert prog.to_json() == ref_prog.to_json()
    assert fan.indices == ref_fan.indices
    state, ref_state = b.initial_state(), ref_b.initial_state()
    assert state.dtype == np.uint32 and (state == ref_state).all()
    want = _u32(ref_b.run())
    assert (_u32(b.run()) == want).all()
    assert (_u32(b.run(fused=False)) == want).all()


def _errors(make):
    """(exception class name, message) of ``make`` in each package."""
    out = []
    for port in (False, True):
        with pytest.raises(Exception) as err:
            make(port)
        out.append((type(err.value).__name__, str(err.value)))
    return out


def _session(port, name="s"):
    return (DramSession("cuda", CPU, name=name) if port
            else RefSession("oracle", REF, name=name))


def _prog(port):
    return Program() if port else RefProgram()


def _bad_program(kind, port):
    p = _prog(port)
    if kind == "row_range":
        p.emit("MAJ", x=3, n_act=4, tag="bad", srcs=(0, 1, 7), dsts=(2,))
    elif kind == "dup_dst":
        p.emit("MRC", n_act=4, srcs=(0,), dsts=(1, 2, 1))
    elif kind == "operands":
        p.emit("MAJ", x=5, n_act=8, srcs=(0, 1, 2), dsts=(3,))
    elif kind == "even_arity":
        p.emit("MAJ", x=2, n_act=4, srcs=(0, 1), dsts=(3,))
    elif kind == "src_count":
        p.emit("COPY", srcs=(0, 1), dsts=(3,))
    else:
        p.emit("XOR", srcs=(0,), dsts=(3,))
    return p


@pytest.mark.parametrize("kind", ["row_range", "dup_dst", "operands",
                                  "even_arity", "src_count",
                                  "unknown_kind"])
@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_validation_errors_match_reference(kind, entry):
    def make(port):
        sess = _session(port)
        state = np.zeros((4, 8), np.uint32)
        getattr(sess, entry)(_bad_program(kind, port), state)

    (ref_t, ref_msg), (t, msg) = _errors(make)
    assert (t, msg) == (ref_t, ref_msg) and t == "ProgramValidationError"


def test_validation_fails_before_any_launch():
    sess = DramSession("cuda", CPU)
    with pytest.raises(ProgramValidationError) as err:
        sess.run_fused(_bad_program("row_range", True),
                       torch.zeros((4, 8), dtype=torch.int32))
    assert sess.dispatch_count == 0
    assert {f.code for f in err.value.findings} == {"OP_ROW_RANGE"}
    # The row count comes from the tensor's shape, never its data: a
    # tensor on the meta device (no data at all) is validated the same.
    meta = DramSession("cuda", ExecutionContext(device="meta"))
    with pytest.raises(ProgramValidationError, match="4-row subarray"):
        meta.run_fused(_bad_program("row_range", True),
                       torch.empty((4, 8), dtype=torch.int32,
                                   device="meta"))


BUILDER_ERRORS = {
    "capacity": lambda b, port: (b.alloc_rows(3), b.alloc_rows(2,
                                                               tag="over")),
    "even_arity": lambda b, port: b.maj(*b.alloc_rows(4)),
    "dup_mrc": lambda b, port: b.mrc(b.alloc_row(), (
        PlaneGroup if port else RefPlaneGroup)((b.alloc_row(tag="d"),) * 2)),
    "not_a_row": lambda b, port: b.not_(3),
    "width": lambda b, port: (b.input(np.zeros(8, np.uint32)),
                              b.input(np.zeros((2, 9), np.uint32))),
    "input_rank": lambda b, port: b.input(np.zeros((1, 2, 3), np.uint32)),
    "no_width": lambda b, port: b.initial_state(),
    "zero_rows": lambda b, port: b.alloc_rows(0, tag="none"),
}


@pytest.mark.parametrize("kind", sorted(BUILDER_ERRORS))
def test_builder_errors_match_reference(kind):
    def make(port):
        b = _session(port).program(rows=4, name="tiny")
        BUILDER_ERRORS[kind](b, port)

    (ref_t, ref_msg), (t, msg) = _errors(make)
    assert (t, msg) == (ref_t, ref_msg)


def test_builder_rejects_foreign_rows_like_reference():
    def make(port):
        sess = _session(port)
        mine, other = sess.program(name="mine"), sess.program(name="other")
        r = other.alloc_rows(3)
        mine.maj(r[0], r[1], r[2])

    (ref_t, ref_msg), (t, msg) = _errors(make)
    assert (t, msg) == (ref_t, ref_msg) and "different program" in msg


# -------------------------------------------------------- row allocators


def _allocator_script(cls):
    """Indices handed out and errors raised over one arena's life."""
    log = []
    a, other = cls(capacity=4, name="arena"), cls(4, name="other")
    first = a.alloc(3, tag="req0")
    log.append((first.indices, a.in_use, a.n_rows))
    a.free(first)
    log.append((a.free_rows, a.in_use, a.n_rows))
    again = a.alloc(4, tag="req1")
    log.append((again.indices, a.in_use, a.n_rows))
    a.free(again[1:3])
    log.append((a.free_rows, a.alloc_row().index, a.in_use))
    for bad in (lambda: a.free(other.alloc(1)), lambda: a.free(again[1]),
                lambda: a.alloc(2, tag="over"), lambda: a.alloc(0)):
        try:
            bad()
        except Exception as e:  # noqa: BLE001 - compared across packages
            log.append((type(e).__name__, str(e)))
    return log


def test_allocator_free_list_matches_reference():
    assert _allocator_script(RowAllocator) == \
        _allocator_script(RefRowAllocator)


# ------------------------------------------------------ the port's own


def test_default_session_is_the_card():
    sess = DramSession()
    assert sess.backend.name == "cuda"
    assert sess.ctx.device == "cuda" and sess.backend.device.type == "cuda"
    assert sess.ctx.certify
    assert repr(sess) == "DramSession(backend='cuda', cache=0 schedules)"


def test_elementwise_waits_for_the_arithmetic_slice():
    """The arithmetic slice is in: ``elementwise`` (which raised
    ``NotImplementedError`` until §8.1 was ported) runs, as a traced,
    addressed Program, and gives numpy's uint32 sums."""
    a = np.array([1, 0xFFFFFFFF, 7, 0x80000000], np.uint32)
    b = np.array([2, 1, 0xFFFFFFF9, 0x80000000], np.uint32)
    out, prog = DramSession("cuda", CPU).elementwise("add", a, b)
    assert (bp.to_u32(out) == a + b).all()
    assert prog.ops and all(op.dsts for op in prog.ops)


@pytest.mark.parametrize("op", ["add", "xor"])
def test_elementwise_matches_pallas_session(op):
    """The fused §8.1 path through both sessions: results, dispatches,
    Programs and all three cache windows, and a repeat is a hit."""
    rng = np.random.default_rng(len(op))
    a, b = rand_u32(rng, 2, 70)
    ref = RefSession("pallas", RefContext(ideal=True))
    sess = DramSession("cuda", CPU)
    for run in range(2):
        with ref.count_dispatches() as ref_scope:
            ref_out, ref_prog = ref.elementwise(op, a, b, tier=5, n_act=32)
        with sess.count_dispatches() as scope:
            out, prog = sess.elementwise(op, a, b, tier=5, n_act=32)
        assert (bp.to_u32(out) == np.asarray(ref_out)).all()
        assert prog.to_json() == ref_prog.to_json()
        assert scope.count == ref_scope.count
        assert _stats(sess.cache) == _stats(ref.cache)
    assert (bp.to_u32(out) == (a + b if op == "add" else a ^ b)).all()
    if op == "add":
        assert scope.count == 34
    assert sess.cache.stats.hits == 1 and sess.cache.stats.misses == 1


def test_oracle_session_elementwise_matches_reference_oracle():
    """A non-batch backend computes gate by gate through the session's
    hooks and records the cost-only Program."""
    rng = np.random.default_rng(77)
    a, b = rand_u32(rng, 2, 45)
    b[3] = 0
    sess = DramSession("oracle", CPU)
    ref = RefSession("oracle", RefContext(ideal=True))
    for op, tier in (("sub", 7), ("xor", 3), ("add", 9)):
        out, prog = sess.elementwise(op, a, b, tier=tier, n_act=16)
        ref_out, ref_prog = ref.elementwise(op, a, b, tier=tier, n_act=16)
        assert (bp.to_u32(out) == np.asarray(ref_out)).all()
        assert prog.to_json() == ref_prog.to_json()
        assert not any(o.dsts for o in prog.ops)
    planes = rand_u32(rng, 3, 6)
    assert (bp.to_u32(sess.gate_maj(list(bp.from_u32(planes, "cpu")), 3,
                                    4))
            == np.asarray(ref.gate_maj(list(jnp.asarray(planes)), 3, 4))).all()
    assert (bp.to_u32(sess.gate_not(bp.from_u32(planes[0], "cpu")))
            == ~planes[0]).all()


def test_certify_opt_out_matches_reference():
    ref_prog = _valid(rand_program(np.random.default_rng(4), n_ops=8))
    state = rand_u32(np.random.default_rng(5), ROWS, WORDS)
    ref = RefSession("pallas", RefContext(ideal=True, certify=False))
    sess = DramSession("cuda", CPU.replace(certify=False))
    ref.run_fused(ref_prog, jnp.asarray(state), mode="megakernel")
    sess.run_fused(_port(ref_prog), state, mode="megakernel")
    assert _stats(sess.cache) == _stats(ref.cache)
    assert sess.cache.certificate_stats.lookups == 0
