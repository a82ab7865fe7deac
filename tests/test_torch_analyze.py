"""The port's analyzer against the reference package's.

``repro_torch.analyze`` is a copy of ``repro.analyze``: both walk the
same integers and numpy tables, so every comparison here is exact —
certificate digests, finding codes, rendered findings and the
(pass, errors, warnings) summary that feeds every digest.  Programs
cross between the packages as JSON, lowerings as numpy tables.
"""

import glob
import json
import os

import numpy as np
import pytest

import repro.analyze as ref_an
from repro.compile import build_schedule as ref_build_schedule
from repro.compile import lower_schedule as ref_lower_schedule
from repro.pud.isa import Program as RefProgram
from repro.session.rows import RowAllocator as RefRowAllocator
from repro_torch import analyze as an
from repro_torch import interop
from repro_torch.analyze.cert import schedule_digest
from repro_torch.compile import build_schedule, lower_schedule
from repro_torch.pud.isa import Program
from repro_torch.session.rows import RowAllocator
from test_compile_differential import rand_program

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json")))
GOLDEN_IDS = [os.path.basename(p)[:-5] for p in GOLDEN_FILES]


def _golden(path):
    """(frozen doc, port Program, reference Program) of one golden."""
    with open(path) as f:
        doc = json.load(f)
    text = json.dumps(doc["ops"])
    return doc, interop.program_from_json(text), RefProgram.from_json(text)


def _port_lowering(ref_low):
    return interop.lowering_from_arrays(ref_low.src, ref_low.dst,
                                        ref_low.inv, ref_low.n_rows,
                                        ref_low.level_meta)


def _rendered(report):
    return [str(f) for f in report.findings]


def _codes(findings):
    return sorted(f.code for f in findings)


# ------------------------------------------------------- certification


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=GOLDEN_IDS)
def test_golden_certificate_digest_matches_frozen(path):
    doc, prog, ref_prog = _golden(path)
    sched = build_schedule(prog)
    low = lower_schedule(sched)
    cert = an.certify(prog, sched=sched, lowering=low)
    frozen = doc["certificate"]
    assert cert.digest == frozen["digest"]
    assert cert.program_key == frozen["program_key"]
    assert cert.lowering_digest == frozen["lowering_digest"] == low.digest()
    assert cert.schedule_digest == schedule_digest(sched)
    ref_sched = ref_build_schedule(ref_prog)
    ref_cert = ref_an.certify(ref_prog, sched=ref_sched,
                              lowering=ref_lower_schedule(ref_sched))
    assert cert.to_dict() == ref_cert.to_dict()


def _mutation_cases():
    return [(path, name) for path in GOLDEN_FILES
            for name in sorted(an.MUTATIONS)]


@pytest.mark.parametrize(
    "path,mutation", _mutation_cases(),
    ids=[f"{os.path.basename(p)[:-5]}-{m}" for p, m in _mutation_cases()])
def test_mutation_rejected_with_reference_codes(path, mutation):
    """Every applicable mutation of every golden is rejected by both
    packages with the same findings; where a golden has no site for a
    mutation, neither package finds one."""
    _, prog, ref_prog = _golden(path)
    ref_sched = ref_build_schedule(ref_prog)
    ref_bad = ref_an.apply_mutation(ref_lower_schedule(ref_sched), mutation)
    sched = build_schedule(prog)
    bad = an.apply_mutation(lower_schedule(sched), mutation)
    assert (bad is None) == (ref_bad is None)
    if bad is None:
        return
    assert bad.digest() == _port_lowering(ref_bad).digest()
    with pytest.raises(an.CertificationError) as err:
        an.certify(prog, sched=sched, lowering=bad)
    with pytest.raises(ref_an.CertificationError) as ref_err:
        ref_an.certify(ref_prog, sched=ref_sched, lowering=ref_bad)
    report, ref_report = err.value.report, ref_err.value.report
    assert report.errors
    assert _codes(report.findings) == _codes(ref_report.findings)
    assert _rendered(report) == _rendered(ref_report)
    assert report.summary() == ref_report.summary()
    assert str(err.value) == str(ref_err.value)


def test_every_mutation_applies_somewhere():
    for name in an.MUTATIONS:
        assert any(an.apply_mutation(
            lower_schedule(build_schedule(_golden(p)[1])), name) is not None
            for p in GOLDEN_FILES), name


# ------------------------------------------------- reports, finding codes


def _random_programs(n=20, seed=0xA7A1):
    rng = np.random.default_rng(seed)
    return [rand_program(rng, n_ops=int(rng.integers(6, 16)))
            for _ in range(n)]


@pytest.mark.parametrize("ref_prog", _random_programs(),
                         ids=[f"rand{i}" for i in range(20)])
def test_report_matches_reference_on_hazard_programs(ref_prog):
    """Random hazard-heavy programs (aliasing, rewrites, dead stores,
    duplicate destinations) give the same report in both packages, on
    the program alone and with its lowering."""
    prog = interop.program_from_json(ref_prog.to_json())
    rep = an.analyze(prog)
    ref_rep = ref_an.analyze(ref_prog)
    assert rep.summary() == ref_rep.summary()
    assert _rendered(rep) == _rendered(ref_rep)
    if not rep.ok:
        return
    ref_sched = ref_build_schedule(ref_prog)
    ref_low = ref_lower_schedule(ref_sched)
    rep = an.analyze(prog, lowering=_port_lowering(ref_low),
                     outputs=range(4))
    ref_rep = ref_an.analyze(ref_prog, sched=ref_sched, lowering=ref_low,
                             outputs=range(4))
    assert rep.summary() == ref_rep.summary()
    assert _rendered(rep) == _rendered(ref_rep)


def _malformed(kind):
    """Reference and port Programs with one class of defect each."""
    progs = []
    for cls in (RefProgram, Program):
        p = cls()
        p.emit("MAJ", x=3, n_act=4, tag="ok", srcs=(0, 1, 2), dsts=(3,))
        if kind == "row_range":
            p.emit("MAJ", x=3, n_act=4, tag="far", srcs=(0, 1, 99),
                   dsts=(1,))
        elif kind == "dup_dst":
            p.emit("MRC", n_act=4, srcs=(0,), dsts=(1, 2, 1))
        elif kind == "even_arity":
            p.emit("MAJ", x=4, n_act=4, srcs=(0, 1, 2, 3), dsts=(4,))
        elif kind == "operands":
            p.emit("MAJ", x=5, n_act=8, srcs=(0, 1, 2), dsts=(4,))
        elif kind == "src_count":
            p.emit("NOT", srcs=(0, 1), dsts=(4,))
        elif kind == "unknown_kind":
            p.emit("XOR", srcs=(0, 1), dsts=(4,))
        elif kind == "under_nact":
            p.emit("MAJ", x=5, n_act=2, srcs=(0, 1, 2, 3, 4), dsts=(5,))
        progs.append(p)
    return progs


@pytest.mark.parametrize("kind", ["row_range", "dup_dst", "even_arity",
                                  "operands", "src_count", "unknown_kind",
                                  "under_nact"])
def test_report_matches_reference_on_malformed_programs(kind):
    ref_prog, prog = _malformed(kind)
    rep = an.analyze(prog, n_rows=8)
    ref_rep = ref_an.analyze(ref_prog, n_rows=8)
    assert rep.summary() == ref_rep.summary()
    assert _rendered(rep) == _rendered(ref_rep)
    assert rep.render(limit=2) == ref_rep.render(limit=2)
    assert _codes(an.check_ops(prog, 8)) == _codes(
        ref_an.check_ops(ref_prog, 8))
    assert rep.ok == (kind == "under_nact")


def test_liveness_and_allocator_audit_match_reference():
    text = None
    findings = []
    for pkg, alloc_cls, prog_cls in ((ref_an, RefRowAllocator, RefProgram),
                                     (an, RowAllocator, Program)):
        alloc = alloc_cls(capacity=8, name="arena")
        rows = alloc.alloc(7)
        alloc.free(rows[4:6])
        p = prog_cls()
        p.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
        p.emit("NOT", srcs=(3,), dsts=(4,))          # row 4 was freed
        p.emit("COPY", srcs=(0,), dsts=(7,))         # past high water
        text = text or p.to_json()
        assert p.to_json() == text
        lt = pkg.lifetimes(p)
        findings.append((
            [str(f) for f in pkg.allocator_findings(p, alloc)],
            [str(f) for f in pkg.liveness_findings(p, inputs=(0, 1),
                                                   outputs=(7,))],
            {r: (v.first_write, v.last_write, v.first_read, v.last_read)
             for r, v in lt.items()}))
    assert findings[0] == findings[1]
    codes = " ".join(findings[1][0] + findings[1][1])
    for code in ("LIVE_USE_AFTER_FREE", "LIVE_UNALLOCATED",
                 "LIVE_LEAKED_ROWS", "LIVE_UNDECLARED_INPUT",
                 "LIVE_DEAD_OP"):
        assert code in codes, code


def test_equivalence_catches_forced_same_level_dependency():
    """A hand-built schedule that puts a reader beside its writer."""
    from repro_torch.compile.schedule import FusedGroup, Schedule

    prog = Program()
    prog.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
    prog.emit("NOT", srcs=(3,), dsts=(4,))
    maj, inv = prog.ops
    bad = Schedule(levels=((FusedGroup("MAJ", 3, (maj,)),
                            FusedGroup("NOT", 1, (inv,))),))
    codes = set(_codes(an.schedule_findings(bad, prog)))
    assert "RACE_RAW_LEVEL" in codes
    assert "EQ_SCHEDULE_ROW" in set(_codes(an.equivalence_findings(
        prog, bad)))
