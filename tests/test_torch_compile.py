"""The port's ISA, scheduler, lowering and cost model against the reference.

These modules are copies of the reference's pure-Python modules, so the
port must reproduce the reference byte for byte: Program JSON, schedule
levels and groups, megakernel tables and their digests, the VMEM planner
and the DRAM-side prices of every golden Program.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from _proptest import sweep
from repro.compile import build_schedule as ref_build_schedule
from repro.compile import lower_schedule as ref_lower_schedule
from repro.compile import plan_vmem as ref_plan_vmem
from repro.core.costmodel import COST as REF_COST
from repro.core.errormodel import ErrorModel as RefErrorModel
from repro.pud.isa import Program as RefProgram
from repro_torch import interop
from repro_torch.compile import build_schedule, lower_schedule, plan_vmem
from repro_torch.core import calibration, commands, power
from repro_torch.core.costmodel import COST
from repro_torch.core.errormodel import ErrorModel
from test_compile_differential import rand_program

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json")))
GOLDEN_IDS = [os.path.basename(p)[:-5] for p in GOLDEN_FILES]


def _golden(path):
    with open(path) as f:
        doc = json.load(f)
    return doc, RefProgram.from_json(json.dumps(doc["ops"]))


def _schedule_ops(sched):
    """(kind, param, ops) per group per level, ops as plain tuples."""
    return [[(g.kind, g.param,
              [(o.kind, o.x, o.n_act, o.tag, o.srcs, o.dsts)
               for o in g.ops]) for g in lvl] for lvl in sched.levels]


def _random_programs(n, seed):
    rng = np.random.default_rng(seed)
    return [rand_program(rng, n_ops=int(rng.integers(4, 20)))
            for _ in range(n)]


PROGRAMS = ([_golden(p)[1] for p in GOLDEN_FILES]
            + _random_programs(20, 0xC0DE))
PROGRAM_IDS = GOLDEN_IDS + [f"rand{i}" for i in range(20)]


@pytest.mark.parametrize("ref_prog", PROGRAMS, ids=PROGRAM_IDS)
def test_program_json_and_schedule_match(ref_prog):
    text = ref_prog.to_json()
    prog = interop.program_from_json(text)
    assert prog.to_json() == text
    assert prog.n_rows() == ref_prog.n_rows()
    assert prog.histogram() == ref_prog.histogram()
    sched, ref_sched = build_schedule(prog), ref_build_schedule(ref_prog)
    assert _schedule_ops(sched) == _schedule_ops(ref_sched)
    assert sched.n_dispatches() == ref_sched.n_dispatches()
    assert sched.per_op_dispatches() == ref_sched.per_op_dispatches()
    assert sched.histogram() == ref_sched.histogram()


@pytest.mark.parametrize("ref_prog", PROGRAMS, ids=PROGRAM_IDS)
def test_lowering_tables_and_digest_match(ref_prog):
    low = lower_schedule(build_schedule(
        interop.program_from_json(ref_prog.to_json())))
    ref_low = ref_lower_schedule(ref_build_schedule(ref_prog))
    assert low.digest() == ref_low.digest()
    for a, b in ((low.src, ref_low.src), (low.dst, ref_low.dst),
                 (low.inv, ref_low.inv)):
        assert a.dtype == b.dtype and (a == b).all()
    assert low.level_meta == ref_low.level_meta
    carried = interop.lowering_from_arrays(
        ref_low.src, ref_low.dst, ref_low.inv, ref_low.n_rows,
        ref_low.level_meta)
    assert carried.digest() == ref_low.digest()
    for rows, words, budget in ((ref_prog.n_rows() + 5, 100, 8 * 2**20),
                                (300, 5000, 64 * 1024)):
        assert plan_vmem(low, rows, words, budget).as_dict() == \
            ref_plan_vmem(ref_low, rows, words, budget).as_dict()


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=GOLDEN_IDS)
def test_golden_frozen_lowering(path):
    doc, ref_prog = _golden(path)
    low = lower_schedule(build_schedule(
        interop.program_from_json(json.dumps(doc["ops"]))))
    frozen = doc["megakernel"]
    assert low.digest() == frozen["table_digest"]
    assert (low.n_levels, low.w_max, low.x_max) == \
        (frozen["n_levels"], frozen["w_max"], frozen["x_max"])
    assert [list(m) for m in low.level_meta] == frozen["level_meta"]


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=GOLDEN_IDS)
@pytest.mark.parametrize("mfr", ["H", "M"])
def test_golden_program_costs_match(path, mfr):
    _, ref_prog = _golden(path)
    prog = interop.program_from_json(ref_prog.to_json())
    em, ref_em = ErrorModel(mfr), RefErrorModel(mfr)
    for kw in ({}, {"pipelined": True}, {"best_group": True},
               {"temp_c": 80.0, "vpp_v": 2.2}):
        assert prog.latency_ns(em, **kw) == ref_prog.latency_ns(ref_em, **kw)
    assert prog.energy_nj(em) == ref_prog.energy_nj(ref_em)


def test_dram_side_is_the_reference_cost_model():
    assert dataclasses.asdict(COST.lat) == dataclasses.asdict(REF_COST.lat)
    assert COST.hbm_pj_per_byte == REF_COST.hbm_pj_per_byte
    for n in calibration.N_ACT_LEVELS:
        assert COST.simra_power_w(n) == REF_COST.simra_power_w(n)
    assert power.power_table()["REF"] == REF_COST.power_w("REF")
    assert commands.apa(1, 2, 1.5, 3.0).duration_ns == 40.5


def test_device_side_is_an_h100_profile():
    assert (COST.peak_flops, COST.hbm_bytes_per_s,
            COST.nvlink_bytes_per_s) == (989e12, 3.35e12, 450e9)
    assert not hasattr(COST, "tpu_avg_w") and not hasattr(COST,
                                                          "ici_bytes_per_s")
    assert COST.dispatch_energy_nj(2) == 2 * COST.kernel_launch_ns \
        * COST.board_w


@sweep(n_cases=4, seed=0xE77)
def test_error_surfaces_match(rng):
    x = int(rng.choice([3, 5, 7, 9]))
    n_act = int(rng.choice([n for n in calibration.N_ACT_LEVELS if n >= x]))
    env = {"temp_c": float(rng.choice([50.0, 70.0, 90.0])),
           "vpp_v": float(rng.choice([2.5, 2.3, 2.1]))}
    for mfr in ("H", "M", "S"):
        em, ref_em = ErrorModel(mfr), RefErrorModel(mfr)
        assert em.majx_success(x, n_act, **env) == \
            ref_em.majx_success(x, n_act, **env)
        assert em.mrc_success(31, **env) == ref_em.mrc_success(31, **env)
        assert em.simra_success(n_act, **env) == \
            ref_em.simra_success(n_act, **env)


def test_context_from_reference_dict():
    from repro.backends import ExecutionContext as RefContext

    ref_ctx = RefContext(mfr="M", temp_c=70.0, ideal=True, tier=7,
                         block_c=1024, interpret=False)
    ctx = interop.context_from_dict(
        {**dataclasses.asdict(ref_ctx), "device": "cpu"})
    for field in ("mfr", "temp_c", "vpp_v", "pattern", "ideal", "tier",
                  "n_act", "certify", "subarray_cols", "seed"):
        assert getattr(ctx, field) == getattr(ref_ctx, field), field
    assert dataclasses.asdict(ctx.timings) == \
        dataclasses.asdict(ref_ctx.timings)
    assert ctx.device == "cpu"
    with pytest.raises(ValueError, match="unknown"):
        interop.context_from_dict({"bogus": 1})
