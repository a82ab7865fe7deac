"""The session layer's hashes, taken once per artifact that cannot change.

``program_key`` keeps a Program's key beside a snapshot of its op
objects and hashes afresh whenever the ops change; ``CompileCache``
builds its lowerings over read-only tables and remembers their digests,
while a lowering a caller built is digested on every certificate check.
Here each memo is held to a fresh hash after every kind of change, its
counters to exact values, and a session whose memos hit to one whose
every call misses, bit for bit.
"""

import copy
import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analyze.cert import CertificationError
from repro_torch.analyze.mutate import MUTATIONS
from repro_torch.backends import ExecutionContext
from repro_torch.compile import compile_op
from repro_torch.compile.megakernel import lower_schedule
from repro_torch.compile.schedule import build_schedule
from repro_torch.kernels.megakernel.plan import plan_for
from repro_torch.pud.isa import Program
from repro_torch.session import CompileCache, DramSession, program_key

CTX = ExecutionContext(device="cpu", tier=5, n_act=32)


def fresh_key(program) -> str:
    """The content hash, computed from scratch."""
    h = hashlib.sha256()
    for op in program.ops:
        h.update(
            f"{op.kind}|{op.x}|{op.n_act}|{op.srcs}|{op.dsts}\n".encode())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _op(op):
    return compile_op(op, 5, 32)


def _program(op="add") -> Program:
    """A Program of its own, holding ``op``'s compiled ops."""
    return Program(list(_op(op).program.ops))


def _image(op, seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 2**32, 64 * 32, dtype=np.uint64)
            .astype(np.uint32) for _ in "ab")
    return _op(op).image(a, b)


# ------------------------------------------------------------ program_key
def _replace(p, i, **fields):
    p.ops[i] = dataclasses.replace(p.ops[i], **fields)


CHANGES = {
    "emit": lambda p: p.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2),
                             dsts=(9,)),
    "extend": lambda p: p.extend(_program("sub")),
    "append": lambda p: p.ops.append(p.ops[0]),
    "pop": lambda p: p.ops.pop(),
    "setitem": lambda p: p.ops.__setitem__(5, p.ops[7]),
    "reassign": lambda p: setattr(p, "ops", p.ops[::-1]),
    "rows": lambda p: _replace(p, 3, dsts=(p.ops[3].dsts[0] + 1,)),
    "tag_only": lambda p: _replace(p, 3, tag="another/tag"),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_is_a_fresh_hash_after_each_change(change):
    p = _program()
    before = program_key(p)
    assert program_key(p) == before == fresh_key(p)
    CHANGES[change](p)
    after = program_key(p)
    assert after == fresh_key(p)
    assert (after == before) == (change == "tag_only")
    assert program_key(p) == after


def test_a_shallow_copy_shares_its_key_and_sees_the_list_change():
    p = _program()
    key = program_key(p)
    q = copy.copy(p)
    assert q.ops is p.ops and program_key(q) == key
    p.ops.pop()
    assert program_key(q) == program_key(p) == fresh_key(p) != key


@pytest.mark.parametrize("calls", [1, 3])
def test_key_counters(calls):
    p = _program()
    with obs.recording() as rec:
        for _ in range(calls):
            assert program_key(p) == fresh_key(p)
    want = {"cache.key_misses": 1, "cache.key_hits": calls - 1}
    assert rec.counters == {k: n for k, n in want.items() if n}


# ----------------------------------------------------- cached lowerings
def test_cache_built_tables_are_read_only_for_good():
    cache = CompileCache()
    low = cache.lowering_for(_program())
    want = lower_schedule(build_schedule(_program()))
    assert low.digest() == want.digest()
    for name in ("src", "dst", "inv"):
        table = getattr(low, name)
        assert np.array_equal(table, getattr(want, name))
        with pytest.raises(ValueError):
            table[0] = 1
        with pytest.raises(ValueError):
            table.setflags(write=True)
        assert not table.flags.writeable


class _CallerLowerings(CompileCache):
    """A cache that hands out the lowerings a caller built."""

    def __init__(self, lowering):
        super().__init__()
        self.lowering = lowering

    def lowering_for(self, program, key=None, sched=None):
        return self.lowering


def test_a_caller_lowering_changed_after_certification_is_caught():
    p = _program()
    low = lower_schedule(build_schedule(p))
    session = DramSession("cuda", CTX, cache=_CallerLowerings(low))
    image = _image("add", 1)
    session.run_fused(p, image, mode="megakernel")
    bad = MUTATIONS["swap_dst"](low)
    np.copyto(low.dst, bad.dst)              # in place, same object
    with pytest.raises(CertificationError):
        session.run_fused(p, image, mode="megakernel")


@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("lowerings", ["cache", "caller"])
def test_run_fused_counters(lowerings, calls):
    """The first call hashes the Program and certifies; each later one
    looks up the key and, for a lowering the cache built, its digest."""
    p = _program()
    cache = CompileCache()
    if lowerings == "caller":
        cache = _CallerLowerings(lower_schedule(build_schedule(p)))
    session = DramSession("cuda", CTX, cache=cache)
    image = _image("add", 2)
    with obs.recording() as rec:
        for _ in range(calls):
            session.run_fused(p, image, mode="megakernel")
    levels = plan_for(cache.lowering_for(p)).n_levels
    digests = "cache.digest_hits" if lowerings == "cache" else \
        "cache.digest_misses"
    want = {"cache.key_misses": 1, "cache.key_hits": calls - 1,
            digests: calls - 1, "megakernel.levels": calls * levels}
    assert rec.counters == {k: n for k, n in want.items() if n}
    assert rec.spans["session.program_key"].calls == calls
    assert rec.spans.get("cache.lowering_digest", obs.SpanStats()).calls \
        == calls - 1


@pytest.mark.parametrize("mode", ["fused", "megakernel"])
@pytest.mark.parametrize("op", ["add", "mul", "div"])
def test_memo_hits_match_a_session_that_always_misses(op, mode):
    """One session runs one Program object three times, every call after
    the first a hit; the other runs a new copy of it through a new
    cache."""
    image = _image(op, 3)
    program = _program(op)
    session = DramSession("cuda", CTX)
    with obs.recording() as rec:
        hits = [session.run_fused(program, image, mode=mode)
                for _ in range(3)]
    want = {"cache.key_misses": 1, "cache.key_hits": 2}
    if mode == "megakernel":
        want["cache.digest_hits"] = 2
    assert {k: n for k, n in rec.counters.items()
            if k.startswith("cache.")} == want
    uncached = DramSession("cuda", CTX, cache=CompileCache())
    miss = uncached.run_fused(_program(op), image, mode=mode)
    for got in hits:
        assert torch.equal(got, miss)
