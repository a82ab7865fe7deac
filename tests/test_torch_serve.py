"""The port's serve layer against the reference package's.

Every case builds the same requests from the same numpy tiles for both
packages and serves them through ``repro.serve.PudService`` (``oracle``,
or ``pallas`` in interpret mode where dispatches are compared) and
through ``repro_torch.serve.PudService`` (``oracle``, or ``cuda`` under
``ExecutionContext(device="cpu")``, where every kernel wrapper takes its
plain version).  What a client sees must agree: per-request results bit
for bit, tick grouping, program keys, certificate digests, dispatches
per tick, admission outcomes and error messages, SLO counts, the async
API and the analyzer CLI.  Wall-clock fields are never compared.
"""

import asyncio
import io
import os
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro.serve as R
import repro_torch.serve as P
from _proptest import rand_u32
from repro.analyze import __main__ as ref_cli
from repro.analyze import certify as ref_certify
from repro.backends import ExecutionContext as RefContext
from repro.compile import build_schedule as ref_build_schedule
from repro.compile import lower_schedule as ref_lower_schedule
from repro.ft.straggler import StragglerDetector as RefStraggler
from repro.session import CompileCache as RefCache
from repro.session import program_key as ref_program_key
from repro_torch.analyze import __main__ as port_cli
from repro_torch.analyze import certify
from repro_torch.backends import ExecutionContext
from repro_torch.compile import build_schedule, lower_schedule
from repro_torch.core import bitplanes as bp
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.interop import program_from_json
from repro_torch.serve import service as port_service
from repro_torch.session import CompileCache, DramSession, program_key

CPU = ExecutionContext(device="cpu", ideal=True)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def ref_svc(backend="oracle", **kw):
    return R.PudService(R.ServiceConfig(backend=backend,
                                        ctx=RefContext(ideal=True), **kw))


def port_svc(backend="cuda", **kw):
    return P.PudService(P.ServiceConfig(backend=backend, ctx=CPU, **kw))


# ------------------------------------------------------------- workloads


def _flip(rng, tile, n):
    """``tile`` with ``n`` distinct bits flipped."""
    out = tile.copy()
    flat = out.reshape(-1)
    pos = rng.choice(flat.size * 32, size=n, replace=False)
    np.bitwise_xor.at(flat, pos // 32,
                      (np.uint32(1) << (pos % 32)).astype(np.uint32))
    return out


def workload(seed, n_heal=3, n_erase=2, n_verify=2, words=8):
    """A deterministic mixed tick as (kind, kwargs) specs over numpy
    tiles: MAJ3 heals of 2 or 3 rows whose flips sit in one replica
    each (replica 0's flips are what ``fixed_bits`` counts), one MAJ5
    heal (its own group), erases with two patterns and fan-outs, and
    integrity checks with known differing bits."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n_heal):
        base = rand_u32(rng, 2 + i % 2, words)
        reps = [base, base, base]
        reps[i % 3] = _flip(rng, base, 3 + i)
        spec.append(("heal", dict(replicas=np.stack(reps), tenant=f"t{i}")))
    base = rand_u32(rng, 2, words)
    spec.append(("heal", dict(replicas=np.stack(
        [_flip(rng, base, 4), base, _flip(rng, base, 5), base, base]),
        tenant="t5x")))
    for i in range(n_erase):
        spec.append(("erase", dict(rows=5 + i, words=words,
                                   pattern=0xDEADBEEF if i % 2 == 0
                                   else 0x12345678,
                                   fanout=4, tenant=f"t{i}")))
    for i in range(n_verify):
        live = rand_u32(rng, 2, words)
        spec.append(("verify", dict(live=live,
                                    reference=_flip(rng, live, 2 + 7 * i),
                                    tenant=f"v{i}")))
    return spec


def requests(pkg, spec, **extra):
    cls = {"heal": pkg.HealRequest, "erase": pkg.EraseRequest,
           "verify": pkg.IntegrityRequest}
    return [cls[kind](**kw, **extra) for kind, kw in spec]


def _u32(x):
    return bp.to_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_results(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert type(w).__name__ == type(g).__name__
        if isinstance(w, Exception):
            assert str(w).split(" shed:")[0] == str(g).split(" shed:")[0]
        elif hasattr(w, "healed"):
            assert isinstance(g.healed, torch.Tensor)
            assert g.healed.dtype == torch.int32
            assert (_u32(g.healed) == np.asarray(w.healed)).all()
            assert g.fixed_bits == w.fixed_bits
        elif hasattr(w, "wiped"):
            assert isinstance(g.wiped, torch.Tensor)
            assert (_u32(g.wiped) == np.asarray(w.wiped)).all()
        else:
            assert (g.mismatch_bits, g.total_bits, g.success_rate) == (
                w.mismatch_bits, w.total_bits, w.success_rate)


# ------------------------------------------------------------- results


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced",
                                                         "sequential"])
@pytest.mark.parametrize("backend", ["oracle", "cuda"])
def test_results_bit_exact_with_reference(backend, coalesce):
    spec = workload(42)
    want = ref_svc(coalesce=coalesce).serve(requests(R, spec))
    got = port_svc(backend, coalesce=coalesce).serve(requests(P, spec))
    assert_same_results(want, got)
    # the planted flips: replica-0 flips are what a heal fixes
    assert [r.fixed_bits for r in got[:4]] == [3, 0, 0, 4]
    assert [r.mismatch_bits for r in got[-2:]] == [2, 9]
    assert (_u32(got[4].wiped) == 0xDEADBEEF).all()


def test_coalesced_equals_sequential_on_the_port():
    spec = workload(7, n_heal=4, n_erase=3, n_verify=3)
    one = port_svc(coalesce=True).serve(requests(P, spec))
    seq = port_svc(coalesce=False).serve(requests(P, spec))
    for a, b in zip(one, seq):
        for field in ("healed", "wiped"):
            if hasattr(a, field):
                assert torch.equal(getattr(a, field), getattr(b, field))
    assert [getattr(r, "fixed_bits", None) for r in one] == \
        [getattr(r, "fixed_bits", None) for r in seq]


def test_heal_decision_rides_along():
    spec = workload(3, n_heal=1, n_erase=0, n_verify=0)
    [w, _] = ref_svc().serve(requests(R, spec))
    [g, _] = port_svc().serve(requests(P, spec))
    assert g.decision is not None
    assert (g.decision.op, g.decision.pud_ns) == (w.decision.op,
                                                  w.decision.pud_ns)


# ------------------------------------------------------------- structure


def instrument(svc):
    """Record every tick's (key, rids, n_ops, n_levels, dispatches) and
    every Program a pooled session runs."""
    ticks, progs = [], []
    execute = svc.batcher.execute

    def traced(plan, session):
        with session.count_dispatches() as scope:
            out = execute(plan, session)
        ticks.append((plan.key, [r.rid for r in plan.requests],
                      out.n_ops, out.n_levels, scope.count))
        return out

    svc.batcher.execute = traced
    for s in svc.sessions:
        inner = s.run_fused

        def run_fused(prog, state, _inner=inner, **kw):
            progs.append(prog)
            return _inner(prog, state, **kw)

        s.run_fused = run_fused
    return ticks, progs


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced",
                                                         "sequential"])
def test_ticks_programs_and_dispatches_equal_reference(coalesce):
    """The reference on ``pallas`` (interpret) and the port on ``cuda``
    (CPU route): the same grouping, Program sizes and levels, program
    keys, certificate digests and kernel dispatches per tick."""
    spec = workload(11, n_heal=3, n_erase=2, n_verify=2)
    ref = ref_svc("pallas", coalesce=coalesce)
    port = port_svc("cuda", coalesce=coalesce)
    ref_ticks, ref_progs = instrument(ref)
    ticks, progs = instrument(port)
    assert_same_results(ref.serve(requests(R, spec)),
                        port.serve(requests(P, spec)))
    assert ticks == ref_ticks
    # heals: MAJ3 and MAJ5 groups (or one a request); erases: one group
    # a pattern, and here one request a pattern
    assert len(progs) == len(ref_progs) == (4 if coalesce else 6)
    assert [t[4] for t in ticks] == [t[4] for t in ref_ticks]
    for rp, pp in zip(ref_progs, progs):
        assert pp.to_json() == rp.to_json()
        assert program_key(pp) == ref_program_key(rp)
        sched, ref_sched = build_schedule(pp), ref_build_schedule(rp)
        assert certify(pp, sched=sched, lowering=lower_schedule(sched)
                       ).digest == ref_certify(
            rp, sched=ref_sched, lowering=ref_lower_schedule(ref_sched)
        ).digest
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert snap.dispatches == ref_snap.dispatches
    assert snap.batches == ref_snap.batches


def test_coalescing_dispatch_counts():
    """16 heals + 16 erases + 16 checks as one tick: 1 MAJX + 1 fan-out +
    32 mismatch launches coalesced, 16 + 16 + 32 sequential (the count
    the chip run checks), the reference's counts on ``pallas``."""
    rng = np.random.default_rng(5)
    spec = [("heal", dict(replicas=np.stack([b, b, _flip(rng, b, 1)]),
                          tenant=f"h{i}"))
            for i, b in enumerate(rand_u32(rng, 16, 2, 8))]
    spec += [("erase", dict(rows=3, words=8, pattern=0xDEADBEEF,
                            fanout=3, tenant=f"e{i}")) for i in range(16)]
    spec += [("verify", dict(live=t, reference=t, tenant=f"v{i}"))
             for i, t in enumerate(rand_u32(rng, 16, 2, 8))]
    for coalesce, want in ((True, 34), (False, 64)):
        port = port_svc(coalesce=coalesce, max_batch=48)
        ref = ref_svc("pallas", coalesce=coalesce, max_batch=48)
        assert_same_results(ref.serve(requests(R, spec)),
                            port.serve(requests(P, spec)))
        assert port.snapshot().dispatches == \
            ref.snapshot().dispatches == want
        assert port.snapshot().batches == ref.snapshot().batches


# ---------------------------------------------------- admission & queueing


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def _counts(snap):
    d = snap.to_dict()
    return {k: d[k] for k in ("completed", "shed", "rejected", "batches",
                              "dispatches", "cache", "tenants",
                              "batch_occupancy")}


def _heals(pkg, seed, n, tenant=None, **kw):
    """``n`` heal requests fixing 3 bits each, from tenant ``t<i>`` (or
    all from ``tenant``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rand_u32(rng, 2, 8)
        out.append(pkg.HealRequest(
            replicas=np.stack([_flip(rng, base, 3), base, base]),
            tenant=tenant or f"t{i}", **kw))
    return out


def both(scenario):
    """Run ``scenario(pkg, make_service)`` for each package; returns
    (reference, port) outcomes."""
    return (_outcome(lambda: scenario(R, ref_svc)),
            _outcome(lambda: scenario(P, lambda **kw: port_svc("oracle",
                                                              **kw))))


def test_queue_full_backpressure():
    def scenario(pkg, make):
        svc = make(queue_depth=2)
        err = _outcome(lambda: svc.serve(_heals(pkg, 1, 3)))
        backlog = svc.backlog
        while svc.backlog:
            svc.tick()
        return err, backlog, _counts(svc.snapshot())

    ref, port = both(scenario)
    assert port == ref
    assert port[0][0] == "QueueFullError" and port[1] == 2


def test_tenant_queue_depth_cap():
    def scenario(pkg, make):
        svc = make(tenant_queue_depth=1)
        return (_outcome(lambda: svc.serve(
            _heals(pkg, 2, 2, tenant="a"))),
            _counts(svc.snapshot()))

    ref, port = both(scenario)
    assert port == ref and "tenant 'a'" in port[0][1]


def test_arena_exhausted_and_released():
    def scenario(pkg, make):
        svc = make(tenant_rows=8)
        first = [r.fixed_bits for r in svc.serve(
            _heals(pkg, 3, 1, tenant="a"))]
        in_use = svc.admission.arena("a").rows_in_use
        err = _outcome(lambda: svc.serve(
            _heals(pkg, 4, 2, tenant="a")))
        return first, in_use, err, _counts(svc.snapshot())

    ref, port = both(scenario)
    assert port == ref
    assert port[1] == 0 and port[2][0] == "ArenaExhaustedError"


@pytest.mark.parametrize("shed_late", [True, False])
def test_deadline_shedding(shed_late):
    def scenario(pkg, make):
        svc = make(shed_late=shed_late)
        late, ok = _heals(pkg, 5, 2)
        late.deadline_s = -0.001
        late.tenant = "late"
        res = svc.serve([late, ok])
        kinds = [type(r).__name__ for r in res]
        return (kinds, [getattr(r, "fixed_bits", None) for r in res],
                svc.admission.arena("late").rows_in_use,
                _counts(svc.snapshot()))

    ref, port = both(scenario)
    assert port == ref
    assert port[0][0] == ("DeadlineExceededError" if shed_late
                          else "HealResult")


def test_priority_order_and_fifo():
    def scenario(pkg, make):
        q = pkg.RequestQueue(max_depth=8)
        lo, n1, n2, hi = _heals(pkg, 6, 4)
        lo.priority, hi.priority = pkg.Priority.LOW, pkg.Priority.HIGH
        for r, t in zip((lo, n1, n2, hi), ("lo", "n1", "n2", "hi")):
            r.tenant = t
            q.push(r)
        order = [r.tenant for r in q.drain()]
        return order, len(q), q.tenant_depth("lo")

    ref, port = both(scenario)
    assert port == ref == (["hi", "n1", "n2", "lo"], 0, 0)


@pytest.mark.parametrize("case", [
    lambda pkg, rng: pkg.HealRequest(replicas=rand_u32(rng, 4, 2, 8)),
    lambda pkg, rng: pkg.HealRequest(),
    lambda pkg, rng: pkg.IntegrityRequest(live=rand_u32(rng, 8),
                                          reference=rand_u32(rng, 8)),
    lambda pkg, rng: pkg.IntegrityRequest(live=rand_u32(rng, 2, 8),
                                          reference=rand_u32(rng, 2, 4)),
    lambda pkg, rng: pkg.EraseRequest(rows=4, words=8, fanout=32),
    lambda pkg, rng: pkg.EraseRequest(rows=0, words=8),
    lambda pkg, rng: pkg.EraseRequest(rows=2, words=8,
                                      pattern=-1).coalesce_key(),
], ids=["even_x", "missing", "rank", "shapes", "fanout", "rows",
        "negative_pattern"])
def test_request_validation_equal(case):
    ref = _outcome(lambda: case(R, np.random.default_rng(7)))
    port = _outcome(lambda: case(P, np.random.default_rng(7)))
    assert port == ref and isinstance(port, tuple)


# ------------------------------------------------------------------ SLO


def test_slo_snapshot_keys_and_counts():
    ref, port = ref_svc("pallas", pool_size=2), port_svc(pool_size=2)
    for seed in range(2):
        spec = workload(seed, n_heal=3, n_erase=1, n_verify=1)
        ref.serve(requests(R, spec))
        port.serve(requests(P, spec))
    want, got = ref.snapshot().to_dict(), port.snapshot().to_dict()
    assert list(got) == list(want)
    assert _counts(port.snapshot()) == _counts(ref.snapshot())
    assert got["completed"] == 12 and got["batch_occupancy"] > 1.0
    assert len(got["session_ema_s"]) == 2


def test_reset_slo_rebases_cache_window():
    def scenario(pkg, make):
        svc = make()
        spec = workload(0, n_heal=2, n_erase=0, n_verify=0)
        svc.serve(requests(pkg, spec))
        svc.reset_slo()
        zero = svc.snapshot().completed
        svc.serve(requests(pkg, workload(1, n_heal=2, n_erase=0,
                                         n_verify=0)))
        return zero, svc.snapshot().cache

    ref, port = both(scenario)
    assert port == ref
    assert port[1]["misses"] == 0 and port[1]["hits"] > 0


def test_slo_monitor_flags_the_same_straggler():
    walls = [(0, 0.001), (1, 0.100), (2, 0.002), (1, 0.090)] * 4
    snaps = []
    for mon, stats in ((R.SloMonitor(n_sessions=3), RefCache().stats),
                       (P.SloMonitor(n_sessions=3), CompileCache().stats)):
        for idx, wall in walls:
            mon.record_batch(2, wall, 1, session_idx=idx)
        snaps.append(mon.snapshot(stats))
    ref, port = snaps
    assert port.slow_sessions == ref.slow_sessions == [1]
    assert port.session_ema_s == ref.session_ema_s
    assert port.batch_occupancy == ref.batch_occupancy == 2.0


@pytest.mark.parametrize("kw", [
    dict(n_workers=3), dict(n_workers=2, ema=[0.5, 1.0]),
    dict(n_workers=2, ema=[0.5, 1.0], n_samples=[0, 3]),
    dict(n_workers=0), dict(n_workers=2, alpha=0.0),
    dict(n_workers=2, ema=np.zeros(3)),
], ids=["cold", "seeded", "seeded_counts", "no_workers", "alpha",
        "shape"])
def test_straggler_detector_equals_reference(kw):
    def run(cls):
        det = cls(**kw)
        for step in range(6):
            for w in range(det.n_workers):
                det.record(w, 1.0 + 1.5 * (w == 1) + 0.01 * step)
        return (det.stragglers(), det.fleet_slowdown(), det.ema.tolist(),
                det.n_samples.tolist())

    assert _outcome(lambda: run(StragglerDetector)) == \
        _outcome(lambda: run(RefStraggler))


# ------------------------------------------------------------ async API


def test_async_submit_and_stop():
    spec = workload(8, n_heal=3, n_erase=2, n_verify=1)

    async def drive(svc, reqs):
        await svc.start()
        out = await asyncio.gather(*(svc.submit(r) for r in reqs))
        await svc.stop()
        return out

    want = asyncio.run(drive(ref_svc(), requests(R, spec)))
    port = port_svc()
    got = asyncio.run(drive(port, requests(P, spec)))
    assert_same_results(want, got)
    assert port.backlog == 0 and port.snapshot().completed == len(spec)


def test_async_submit_shed_raises():
    async def drive():
        svc = port_svc()
        await svc.start()
        try:
            [late] = _heals(P, 9, 1, deadline_s=-0.001)
            with pytest.raises(P.DeadlineExceededError):
                await svc.submit(late)
        finally:
            await svc.stop()
        return svc.snapshot().shed

    assert asyncio.run(drive()) == 1


# -------------------------------------------------- the batch's wall


def test_batch_wall_waits_for_the_device(monkeypatch):
    """A tick reads its clock only after the session's device finished
    the batch: ``_finish`` runs after ``execute`` and before the wall is
    recorded, and synchronizes a CUDA device (and nothing on the CPU)."""
    events = []
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))

    class Stub:
        class backend:
            device = torch.device("cuda", 0)

    port_service._finish(Stub())
    assert synced == [torch.device("cuda", 0)]
    port_service._finish(DramSession("cuda", CPU))
    assert synced == [torch.device("cuda", 0)]

    svc = port_svc()
    execute = svc.batcher.execute
    record = svc.slo.record_batch
    finish = port_service._finish
    svc.batcher.execute = lambda *a: (events.append("execute"),
                                      execute(*a))[1]
    svc.slo.record_batch = lambda *a, **k: (events.append("wall"),
                                            record(*a, **k))[1]
    monkeypatch.setattr(port_service, "_finish",
                        lambda s: (events.append("finish"), finish(s)))
    svc.serve(requests(P, workload(1, n_heal=1, n_erase=1, n_verify=0)))
    assert events == ["execute", "finish", "wall"] * 3  # MAJ3, MAJ5, erase


# ------------------------------------------- inputs the reference accepts


def test_session_takes_what_the_reference_takes():
    """``session.mismatch`` (and so integrity checks) take lists, 0-d
    values and read-only arrays as the reference does, without a
    warning, and use a tensor already on the device as it is."""
    from repro.session import DramSession as RefSession

    sess, ref = DramSession("cuda", CPU), RefSession("oracle",
                                                     RefContext(ideal=True))
    ro = np.frombuffer(np.arange(8, dtype=np.uint32).tobytes(), np.uint32)
    cases = [([1, 2, 3, 4], [0, 0, 0, 0]), (np.uint32(7), np.uint32(0)),
             (ro, np.zeros(8, np.uint32)),
             (np.array([-1, 2]), np.zeros(2, np.int64))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for a, b in cases:
            assert int(sess.mismatch(a, b)) == int(ref.mismatch(a, b))
        live = np.frombuffer(bytes(range(64)), np.uint32).reshape(2, 8)
        [res] = port_svc().serve([P.IntegrityRequest(
            live=live, reference=np.zeros((2, 8), np.uint32))])
    assert res.mismatch_bits == int(ref.mismatch(live, np.zeros((2, 8),
                                                                np.uint32)))
    t = bp.from_u32(np.arange(4, dtype=np.uint32), "cpu")
    assert sess.backend.words(t) is t


# ------------------------------------------------------- analyzer CLI


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_analyzer_cli_matches_reference():
    argv = ["--golden", "--serve", "--mutate", "--cache-check",
            "--golden-dir", GOLDEN_DIR]
    rc_ref, ref = _cli(ref_cli.main, argv)
    rc, port = _cli(port_cli.main, argv + ["--device", "cpu"])
    assert rc == rc_ref == 0
    assert port == ref
    assert any(line.startswith("OK   serve/tick") for line in port)


def test_analyzer_cli_sweep_waits():
    """``--sweep`` no longer waits for the sweep port: it certifies the
    smoke sweep's chunk programs, and ``--all`` includes them, with the
    reference's lines and digests."""
    rc_ref, ref = _cli(ref_cli.main, ["--sweep"])
    rc, out = _cli(port_cli.main, ["--sweep"])
    assert rc == rc_ref == 0 and out == ref
    assert any(line.startswith("OK   sweep/smoke/chunk-") for line in out)
    argv = ["--all", "--golden-dir", GOLDEN_DIR]
    rc_ref, ref = _cli(ref_cli.main, argv)
    rc, out = _cli(port_cli.main, argv + ["--device", "cpu"])
    assert rc == rc_ref == 0 and out == ref
    assert out[-1] == "analyze: all gates passed"


def test_serve_tick_programs_cross_over():
    """The tick Program JSON the reference builds is the port's Program."""
    ref = ref_svc()
    _, ref_progs = instrument(ref)
    ref.serve(requests(R, workload(2, n_heal=2, n_erase=1, n_verify=0)))
    for rp in ref_progs:
        assert program_key(program_from_json(rp.to_json())) == \
            ref_program_key(rp)
