"""``repro_torch.obs``: spans and counters inside the port, on the CPU.

The span tree's arithmetic (self = total less the children), windows
that hold only their own closings, the off path (no ``record_function``,
one shared no-op), the profiler's annotations, and the exact counts the
arith path leaves per ``run_fused`` call on ``CudaBackend(device="cpu")``
for the programs ``compile_elementwise`` traces at tier 5, n_act 32.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.sweep as sweep
from repro_torch import obs
from repro_torch.backends import ExecutionContext
from repro_torch.backends.cuda import CudaBackend
from repro_torch.compile.trace import compile_elementwise
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.megakernel.plan import plan_for
from repro_torch.session import DramSession

#: (index uploads, levels) of one fused ``run_fused`` call.
FUSED_COUNTS = {"add": (226, 34), "sub": (228, 35), "mul": (1060, 157)}
SWEEP_SPANS = ("sweep.draws", "sweep.upload", "sweep.fused_run",
               "sweep.oracle", "sweep.counts")


def _compiled(op):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2**32, 64, dtype=np.uint32)
    b = rng.integers(0, 2**32, 64, dtype=np.uint32)
    cp = compile_elementwise(op, a, b, tier=5, n_act=32)
    return cp, torch.from_numpy(cp.state.view(np.int32)), a, b


def test_nested_spans_add_up():
    with obs.recording() as rec:
        with obs.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with obs.span("inner"):
                    with obs.span("leaf"):
                        time.sleep(0.001)
        with obs.span("outer"):
            pass
    outer, inner, leaf = (rec.spans[n] for n in ("outer", "inner", "leaf"))
    assert (outer.calls, inner.calls, leaf.calls) == (2, 2, 2)
    assert outer.parents == {None: 2}
    assert inner.parents == {"outer": 2}
    assert leaf.parents == {"inner": 2}
    assert outer.self_s + inner.total_s == pytest.approx(outer.total_s,
                                                         abs=1e-9)
    assert inner.self_s + leaf.total_s == pytest.approx(inner.total_s,
                                                        abs=1e-9)
    assert leaf.self_s == leaf.total_s >= 0.002
    assert outer.self_s >= 0.002
    assert rec.window_s >= outer.total_s


def test_recordings_hold_only_their_own_window():
    with obs.recording() as first:
        with obs.span("a"):
            obs.count("n", 3)
    with obs.span("between"):
        obs.count("n", 100)
    with obs.recording() as second:
        with pytest.raises(RuntimeError, match="already open"):
            with obs.recording():
                pass
        with obs.span("b"):
            obs.count("n")
        obs.count("n", 2)
    assert set(first.spans) == {"a"} and first.counters == {"n": 3}
    assert set(second.spans) == {"b"} and second.counters == {"n": 3}
    assert obs.span("after") is obs.span("again")     # both closed


def test_off_path_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(obs, "record_function", refuse)
    assert obs.span("x") is obs.span("y")        # one shared no-op
    assert obs.count("x") is None
    x = torch.arange(64, dtype=torch.int32)
    assert torch.equal(bp.unpack_uint_elements(bp.pack_uint_elements(x),
                                               64), x)
    with obs.recording() as rec:                  # a recording alone
        bp.pack_uint_elements(x)                  # takes no range either
    assert rec.spans["bitplanes.pack"].calls == 1


def test_spans_are_profiler_annotations():
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(64, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            planes = bp.pack_uint_elements(x)
        bp.unpack_uint_elements(planes, 64)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"outer", "bitplanes.pack", "bitplanes.unpack"} <= names
    assert obs.span("after") is obs.span("again")


@pytest.mark.parametrize("op", sorted(FUSED_COUNTS))
def test_fused_run_counts_uploads_and_levels(op):
    cp, state, _, _ = _compiled(op)
    backend = CudaBackend(ExecutionContext(device="cpu"))
    plain = backend.run_fused(cp.program, state, mode="fused")
    with obs.recording() as rec:
        got = backend.run_fused(cp.program, state, mode="fused")
    uploads, levels = FUSED_COUNTS[op]
    assert rec.counters == {"backend.index_uploads": uploads,
                            "cuda.levels": levels}
    assert rec.spans["cuda.run_fused"].calls == 1
    assert torch.equal(got, plain)


@pytest.mark.parametrize("op", sorted(FUSED_COUNTS))
def test_megakernel_session_call_and_outputs(op):
    """Megakernel mode uploads nothing a call and counts its plan's
    levels; ``outputs`` one row tensor; the backend's span is the
    session's child."""
    cp, state, a, b = _compiled(op)
    cp.n_lanes = 64
    session = DramSession(CudaBackend(ExecutionContext(device="cpu")))
    session.run_fused(cp.program, state, mode="megakernel")
    with obs.recording() as run:
        final = session.run_fused(cp.program, state, mode="megakernel")
    with obs.recording() as unpack:
        got = cp.outputs(final)
    plan = plan_for(session.cache.lowering_for(cp.program))
    assert run.counters == {"megakernel.levels": plan.n_levels,
                            "cache.key_hits": 1, "cache.digest_hits": 1}
    assert unpack.counters == {"backend.index_uploads": 1}
    assert run.spans["session.run_fused"].parents == {None: 1}
    assert run.spans["cuda.run_fused"].parents == {"session.run_fused": 1}
    assert set(unpack.spans) == {"bitplanes.unpack"}
    want = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    assert np.array_equal(bp.to_u32(got), want)


def test_sweep_runner_records_its_spans(tmp_path):
    spec = sweep.SweepSpec(name="obs", backends=("cuda",), x_values=(3,),
                           n_act=(8, 32), rows=2, words=16, chunk=2)
    with obs.recording() as rec:
        sweep.run_sweep(spec, str(tmp_path), device="cpu")
    assert set(SWEEP_SPANS) <= set(rec.spans)
    assert rec.spans["session.run_fused"].parents == {
        "sweep.fused_run": rec.spans["sweep.fused_run"].calls}


def test_threads_keep_their_own_stacks_and_lose_no_count():
    n_threads, n = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.recording() as rec:
            def work(k):
                for _ in range(n):
                    with obs.span(f"t{k}"):
                        with obs.span("child"):
                            obs.count("n")

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters == {"n": n_threads * n}
    assert rec.spans["child"].parents == {f"t{k}": n
                                          for k in range(n_threads)}
    assert all(rec.spans[f"t{k}"].parents == {None: n}
               for k in range(n_threads))
