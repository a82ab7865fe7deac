"""The megakernel's execution plan against the padded tables it is
derived from, and against the reference.

``kernels/megakernel/plan.py`` keeps only the slots of a lowering whose
writes can be observed, drops matched constant operand pairs and marks
hazard slots; ``exec_plan_ref`` walks that plan and is the CPU route of
``run_lowering``.  Here the walk must equal ``schedule_exec_ref`` (the
per-slot walk of the padded tables) and, through a ``DramSession``, the
reference's ``pallas`` session in interpret mode, on the goldens, random
hazard-heavy programs, §8.1 lowerings and hand-made tables that hit each
of the plan's rules.  All comparisons are bit-exact; the tables and
their digests must come out of planning unchanged.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_u32
from repro.backends import ExecutionContext as RefContext
from repro.backends import get_backend as ref_get_backend
from repro.compile import build_schedule as ref_build_schedule
from repro.compile import lower_schedule as ref_lower_schedule
from repro.pud.isa import Program as RefProgram
from repro.session import DramSession as RefSession
from repro_torch import interop
from repro_torch.backends import ExecutionContext, get_backend
from repro_torch.compile import (build_schedule, compile_elementwise,
                                 lower_schedule)
from repro_torch.compile.megakernel import (MegaLowering, ONE_ROW,
                                            TRASH_ROW, ZERO_ROW)
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.plan import (STAGE_LEVELS, STAGE_OPS,
                                                 STAGE_SLOTS, build_plan,
                                                 exec_plan_ref, plan_for,
                                                 plan_key, plan_launch)
from repro_torch.kernels.megakernel.ref import schedule_exec_ref
from repro_torch.session import DramSession
from test_compile_differential import rand_program

CPU = ExecutionContext(device="cpu", ideal=True)
REF = RefContext(ideal=True)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json")))
GOLDEN_IDS = [os.path.basename(p)[:-5] for p in GOLDEN_FILES]


def _t(a):
    return bp.from_u32(np.asarray(a, np.uint32), "cpu")


def _check_plan(low: MegaLowering, state) -> None:
    """Plan ``low`` and hold the walk to the padded walk; the tables and
    their digest are not touched, and the hazard marks are exactly the
    kept slots whose destination another kept slot of the level reads."""
    digest = low.digest()
    tables = [a.copy() for a in (low.src, low.dst, low.inv)]
    plan = build_plan(low)
    assert low.digest() == digest
    assert all((a == b).all() for a, b in zip(tables,
                                              (low.src, low.dst, low.inv)))
    assert plan.key == plan_key(low) != digest
    state = _t(state)
    got = exec_plan_ref(plan, state)
    assert torch.equal(got, schedule_exec_ref(low, state))
    marks = plan.hazard_mask()
    for lo, hi in zip(plan.level_ptr[:-1], plan.level_ptr[1:]):
        assert hi > lo, "empty levels are dropped"
        dsts = plan.dst[lo:hi].tolist()
        assert len(set(dsts)) == len(dsts), "one writer a row a level"
        for s in range(lo, hi):
            others = {r for t in range(lo, hi) if t != s
                      for r in plan.operands[plan.op_ptr[t]:
                                             plan.op_ptr[t + 1]].tolist()}
            assert marks[s] == (plan.dst[s] in others), s
        # plain slots first, hazard slots last
        assert list(marks[lo:hi]) == sorted(marks[lo:hi])


# ----------------------------------------------------------- goldens


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=GOLDEN_IDS)
def test_plan_walk_matches_padded_walk_and_reference_on_goldens(path):
    with open(path) as f:
        doc = json.load(f)
    prog = interop.program_from_json(json.dumps(doc["ops"]))
    low = lower_schedule(build_schedule(prog))
    assert low.digest() == doc["megakernel"]["table_digest"]
    rng = np.random.default_rng((doc["seed"], 0x601D))
    state = rng.integers(0, 2**32, (doc["rows"], doc["words"]),
                         dtype=np.uint32)
    _check_plan(low, state)
    assert low.digest() == doc["megakernel"]["table_digest"]
    plan = plan_for(low)
    assert plan_for(low) is plan
    assert plan.n_slots == sum(map(sum, low.level_meta))
    # Through the session: the port's megakernel mode (the plan walk on
    # the CPU) against the reference's pallas session in interpret mode.
    ref_p = RefProgram.from_json(json.dumps(doc["ops"]))
    want = np.asarray(RefSession("pallas", REF).run_fused(
        ref_p, jnp.asarray(state), mode="megakernel"))
    got = DramSession("cuda", CPU).run_fused(prog, state, mode="megakernel")
    assert (bp.to_u32(got) == want).all()


# ----------------------------------------- random hazard-heavy programs


def _random_cases(n=20, seed=0x70C4):
    """The 20 random programs of ``test_torch_backends.py``."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        prog = rand_program(rng, n_ops=int(rng.integers(6, 16)))
        cases.append((prog, rand_u32(rng, 20, 8)))
    return cases


@pytest.mark.parametrize("case", _random_cases(),
                         ids=[f"rand{i}" for i in range(20)])
def test_plan_walk_matches_on_random_hazard_programs(case):
    ref_prog, state = case
    prog = interop.program_from_json(ref_prog.to_json())
    low = lower_schedule(build_schedule(prog))
    ref_low = ref_lower_schedule(ref_build_schedule(ref_prog))
    assert low.digest() == ref_low.digest()
    if low.n_levels:
        _check_plan(low, state)
    # The backend's megakernel mode walks the plan on the CPU; the
    # reference's pallas backend runs the padded tables in interpret mode.
    want = np.asarray(ref_get_backend("pallas", REF).run_fused(
        ref_prog, jnp.asarray(state), mode="megakernel"))
    got = get_backend("cuda", CPU).run_fused(prog, state, mode="megakernel")
    assert (bp.to_u32(got) == want).all()


def test_random_programs_have_hazards_to_mark():
    """The random set exercises the hazard rule, not only plain slots."""
    n = sum(build_plan(lower_schedule(build_schedule(
        interop.program_from_json(p.to_json())))).max_hazard > 0
        for p, _ in _random_cases() if len(p.ops))
    assert n >= 5


# ------------------------------------------------------------- §8.1


def _numpy(op, a, b):
    if op == "div":
        return np.where(b == 0, np.uint32(0xFFFFFFFF),
                        a // np.where(b == 0, 1, b)).astype(np.uint32)
    return {"add": np.add, "mul": np.multiply}[op](a, b).astype(np.uint32)


@pytest.mark.parametrize("op,tier", [("add", 5), ("mul", 5), ("div", 5),
                                     ("div", 3)])
def test_plan_walk_on_arith_lowerings(op, tier):
    """§8.1 lowerings at two words a plane (64 lanes): the plan walk
    equals the padded walk (div at MAJ3 pads some 3,500 levels to ~1,000
    slots), the level-fused run of the same schedule, and numpy."""
    rng = np.random.default_rng(len(op) + tier)
    a, b = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    b[::7] = 0
    b[1::5] = rng.integers(0, 256, len(b[1::5]), dtype=np.uint32)
    cp = compile_elementwise(op, a, b, tier=tier, n_act=32)
    sched = build_schedule(cp.program)
    low = lower_schedule(sched)
    plan = build_plan(low)
    assert plan.n_slots == sum(map(sum, low.level_meta))
    assert plan.max_hazard == 0       # traced programs write fresh rows
    state = _t(cp.state)
    got = exec_plan_ref(plan, state)
    assert (bp.to_u32(cp.outputs(got)) == _numpy(op, a, b)).all()
    assert torch.equal(got, get_backend("cuda", CPU).run_fused(
        cp.program, cp.state, sched=sched))
    _check_plan(low, cp.state)
    out = mega_ops.run_lowering(low, state)
    assert torch.equal(out, got)


# ------------------------------------------------------ hand-made tables


def _low(levels, n_rows):
    """A MegaLowering from ``[(src rows, dst, inv), ...]`` per level (all
    of one arity), padded with inert slots: ZERO_ROW operands, TRASH_ROW
    destination."""
    w = max(len(lv) for lv in levels)
    x = len(levels[0][0][0])
    src = np.full((len(levels), w, x), ZERO_ROW, np.int32)
    dst = np.full((len(levels), w), TRASH_ROW, np.int32)
    inv = np.zeros((len(levels), w), np.uint32)
    for li, lv in enumerate(levels):
        for si, (s, d, f) in enumerate(lv):
            assert len(s) == x
            src[li, si] = s
            dst[li, si] = d
            inv[li, si] = f
    meta = tuple((len(lv), 0, 0, 0) for lv in levels)
    return MegaLowering(src=src, dst=dst, inv=inv, n_rows=n_rows,
                        level_meta=meta)


R = 3       # first program row in the augmented image
Z, O = ZERO_ROW, ONE_ROW

HAND = {
    # An inert-looking slot writes ONES into the trash row; the next
    # level reads it, a level of padding zeroes it, and a later level
    # reads it again: every trash writer must be kept.
    "trash_read_after_padded_level": _low(
        [[((R + 1, R + 2, R + 3), R, 0), ((Z, Z, Z), TRASH_ROW, 1)],
         [((TRASH_ROW, R, R + 1), R + 4, 0)],
         [],
         [((TRASH_ROW, R + 4, R + 1), R + 5, 0)]], 6),
    # Unpaired constants stay, matched (0, 1) pairs go.
    "unpaired_constants": _low(
        [[((R, Z, Z, Z, Z), R + 1, 0),
          ((R, Z, Z, O, R + 4), R + 2, 0),
          ((R, O, O, O, Z), R + 3, 1),
          ((Z, O, Z, O, R), R + 5, 0)]], 6),
    # A level of padding only, between two real levels.
    "all_padding_level": _low(
        [[((R, R + 1, R + 2), R + 3, 0)],
         [],
         [((R + 3, O, Z), R + 4, 1)]], 6),
    # A swap inside one level: both slots are hazard slots.
    "swap_in_one_level": _low(
        [[((R,), R + 1, 0), ((R + 1,), R, 0), ((R + 2,), R + 3, 1)]], 5),
    # A rotation of three rows, and a slot that reads its own
    # destination (not a hazard by itself).
    "rotation_and_self_read": _low(
        [[((R + 1, Z, O), R, 0), ((R + 2, Z, O), R + 1, 0),
          ((R, Z, O), R + 2, 1), ((R + 3, R + 4, R + 5), R + 3, 0)]], 6),
    # A slot writes ones into the zero row; a later (0, 1) pair is then
    # no constant pair and must be kept.
    "constant_row_written": _low(
        [[((O, O, O), Z, 0)],
         [((R, Z, O), R + 1, 0)]], 3),
    # Two slots of one level write the same row: the last one's vote
    # stands, and the slot that reads that row makes it a hazard.
    "two_writers_one_level": _low(
        [[((R, R + 1, R + 2), R + 3, 0), ((R + 1, Z, O), R + 3, 1),
          ((R + 3, Z, O), R + 4, 0)]], 5),
    # An even arity: strict majority, 2 of 4 is not enough.
    "even_arity": _low(
        [[((R, R + 1, R + 2, R + 3), R + 4, 0),
          ((R, R + 1, Z, O), R + 5, 0)]], 6),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_plan_walk_on_hand_made_tables(name):
    low = HAND[name]
    state = rand_u32(np.random.default_rng(len(name)), low.n_rows + 1, 5)
    state[:, 0] = 0xFFFFFFFF
    state[1, 1] = 0
    _check_plan(low, state)
    assert torch.equal(mega_ops.run_lowering(low, _t(state)),
                       schedule_exec_ref(low, _t(state)))


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_made_tables_match_the_reference(name):
    """The same tables through the reference: its padded-table oracle
    (strict majority) on every table, and its Pallas kernel in interpret
    mode where the arity is odd.  On an even arity the reference's
    kernel counts a tie as 1 (threshold ``(x + 1) // 2``) where its
    oracle counts it as 0; the port follows the oracle (ROADMAP queue
    3), and the test pins that disagreement."""
    from repro.compile.megakernel import MegaLowering as RefLowering
    from repro.kernels.megakernel import ops as ref_mega_ops
    from repro.kernels.megakernel import ref as ref_mega_ref

    low = HAND[name]
    ref_low = RefLowering(src=low.src, dst=low.dst, inv=low.inv,
                          n_rows=low.n_rows, level_meta=low.level_meta)
    state = rand_u32(np.random.default_rng(len(name)), low.n_rows + 1, 5)
    state[:, 0] = 0xFFFFFFFF
    state[1, 1] = 0
    got = bp.to_u32(mega_ops.run_lowering(low, _t(state)))
    np.testing.assert_array_equal(
        got, ref_mega_ref.schedule_exec_ref(ref_low, state))
    kernel = np.asarray(ref_mega_ops.run_lowering(
        ref_low, jnp.asarray(state), interpret=True))
    if low.x_max % 2:
        np.testing.assert_array_equal(got, kernel)
    else:
        assert not np.array_equal(got, kernel)


def test_hand_made_plans_apply_each_rule():
    def plan(name):
        return build_plan(HAND[name])

    p = plan("trash_read_after_padded_level")
    assert p.n_levels == 4 and p.dst.tolist().count(TRASH_ROW) == 4
    p = plan("all_padding_level")
    assert p.n_levels == 2 and p.arity.tolist() == [3, 1]
    p = plan("unpaired_constants")
    assert p.arity.tolist() == [5, 3, 3, 1]
    assert p.thresh.tolist() == [3, 2, 2, 1] and p.max_hazard == 0
    p = plan("swap_in_one_level")
    assert p.hazard_mask().tolist() == [False, True, True]
    assert p.dst.tolist() == [R + 3, R + 1, R]
    p = plan("rotation_and_self_read")
    assert p.n_hazard.tolist() == [3] and p.dst[0] == R + 3
    p = plan("constant_row_written")
    assert p.arity.tolist() == [3, 3]
    p = plan("two_writers_one_level")
    assert p.dst.tolist() == [R + 4, R + 3] and p.inv.tolist() == [0, 1]
    assert p.hazard_mask().tolist() == [False, True]
    p = plan("even_arity")
    assert p.arity.tolist() == [4, 2] and p.thresh.tolist() == [3, 2]


# ----------------------------------------------------- the launch planner


def test_launch_planner_regimes():
    add32 = json.load(open(os.path.join(GOLDEN_DIR, "add32.json")))
    low = lower_schedule(build_schedule(interop.program_from_json(
        json.dumps(add32["ops"]))))
    plan = plan_for(low)
    stage = plan.stage_bytes
    assert plan.stage == (34, 96, len(plan.operands))
    lp = plan_launch(plan, 161, 2**18)
    assert (lp.regime, lp.strip, lp.threads) == ("resident", 128, 256)
    assert lp.smem_bytes == 164 * 128 * 4 + stage
    assert lp.blocks == 2**18 // 128
    # 2177 program rows (mul at tier 5): 26 columns an SM are too few to
    # stay resident, so the image streams, 32 columns a block.
    lp = plan_launch(plan, 2177, 2**18)
    assert (lp.regime, lp.strip, lp.threads) == ("streaming", 32, 128)
    assert lp.smem_bytes == stage
    forced = plan_launch(plan, 2177, 2**18, regime="resident")
    assert (forced.strip, forced.smem_bytes) == (8, 2180 * 8 * 4 + stage)
    # 14,849 rows (div at MAJ3) over one rank row: 16 columns a block
    # still give half the SMs a block.
    lp = plan_launch(plan, 14849, 2048)
    assert (lp.regime, lp.strip, lp.smem_bytes) == ("streaming", 16, stage)
    assert lp.blocks == 128
    # The crossover: 96 columns of a 600-row image fit an SM, of 700 not.
    assert plan_launch(plan, 597, 2**16).regime == "resident"
    assert plan_launch(plan, 697, 2**16).regime == "streaming"
    # Streaming strips narrow with the word count, to keep half the SMs
    # busy: ragged at 100 (1 column a block), 1001 (8) and 2100 (32).
    for words, strip in ((100, 1), (1001, 8), (2100, 32), (2**18, 32)):
        lp = plan_launch(plan, 161, words, regime="streaming")
        assert (lp.strip, lp.blocks) == (strip, -(-words // strip))
    with pytest.raises(ValueError, match="shared memory"):
        plan_launch(plan, 14849, 2048, regime="resident")
    with pytest.raises(ValueError, match="regime"):
        plan_launch(plan, 161, 64, regime="bogus")
    hazards = build_plan(HAND["rotation_and_self_read"])
    lp = plan_launch(hazards, 6, 64, regime="streaming")
    assert lp.smem_bytes == -(-3 * lp.strip * 4 // 16) * 16 + \
        hazards.stage_bytes


def _wide_level_program(fan: int):
    """A MAJ level, one Multi-RowCopy level of ``fan`` destinations, and
    a NOT level: with ``fan`` above the stage's slots the middle level is
    a chunk of its own that the kernel reads from device memory."""
    from repro_torch.pud.isa import Program

    prog = Program()
    prog.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
    prog.emit("MRC", n_act=8, srcs=(3,), dsts=tuple(range(4, 4 + fan)))
    prog.emit("NOT", srcs=(4 + fan // 2,), dsts=(0,))
    return prog


@pytest.mark.parametrize("fan", [5, STAGE_SLOTS + 88])
def test_plan_chunks_cover_the_levels(fan):
    low = lower_schedule(build_schedule(_wide_level_program(fan)))
    plan = build_plan(low)
    chunks = plan.chunks
    assert chunks[0, 0] == 0 and chunks[-1, 1] == plan.n_levels
    assert (chunks[1:, 0] == chunks[:-1, 1]).all()
    for l0, l1, s0, s1, o0, o1, staged, _ in chunks.tolist():
        assert (s0, s1) == (plan.level_ptr[l0], plan.level_ptr[l1])
        assert (o0, o1) == (plan.op_ptr[s0], plan.op_ptr[s1])
        assert staged == int(l1 - l0 <= STAGE_LEVELS
                             and s1 - s0 <= STAGE_SLOTS
                             and o1 - o0 <= STAGE_OPS)
    assert chunks[:, 6].tolist() == ([1] if fan == 5 else [1, 0, 1])
    state = rand_u32(np.random.default_rng(fan), 4 + fan, 3)
    _check_plan(low, state)


def test_many_levels_make_many_chunks():
    """div at MAJ3 over one word: some 3,500 levels in staged chunks of
    at most STAGE_LEVELS levels."""
    a, b = np.arange(1, 33, dtype=np.uint32), np.full(32, 3, np.uint32)
    cp = compile_elementwise("div", a, b, tier=3, n_act=32)
    plan = build_plan(lower_schedule(build_schedule(cp.program)))
    chunks = plan.chunks
    assert len(chunks) >= plan.n_levels // STAGE_LEVELS > 5
    assert chunks[:, 6].all()
    assert plan.stage[0] <= STAGE_LEVELS and plan.stage[1] <= STAGE_SLOTS
