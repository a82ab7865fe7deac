"""The port's own spans (``repro_torch.obs``) beside the benchmark's.

With program spans nested inside the benchmark's ``bench.*`` spans, the
trace and every reader read what they read without them; a run's
untraced windows take the spans' off path and open no recording."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from port_bench.tests._util import SEED, SMALL, cells_of, spec_and_shelved
from port_bench.harness import runner
from port_bench.harness.record import Record
from port_bench.harness.spec import metric_reader
from port_bench.harness.trace import OUTSIDE, Profiler, TraceData

ARITH = cells_of("arith")
FULL = spec_and_shelved()


class Event:
    """What ``TraceData.from_events`` reads of a profiler event."""

    def __init__(self, name, start, end, *, device=False,
                 annotation=False, corr=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation, self._corr = device, annotation, corr

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._device else DeviceType.CPU

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr


def _ranges(spans):
    """A range on the host and its annotation on the device's timeline."""
    return [Event(n, s, e, device=d, annotation=True)
            for n, s, e in spans for d in (False, True)]


BENCH = _ranges([("bench.window", 0, 1000), ("bench.pack", 10, 100),
                 ("bench.run_fused", 100, 600), ("bench.unpack", 600, 700),
                 ("bench.wait", 700, 900)])
LAUNCHES = [Event("cudaLaunchKernel", t, t + 3, corr=c)
            for t, c in ((20, 1), (150, 2), (400, 3), (620, 4))] + [
    Event("cudaMemsetAsync", 950, 953, corr=5)]
DEVICE = [Event(n, s, e, device=True, corr=c) for n, s, e, c in (
    ("pack_kernel", 30, 90, 1), ("majx_kernel", 200, 300, 2),
    ("megakernel_streaming", 450, 500, 3), ("unpack_kernel", 650, 750, 4),
    ("Memset", 960, 970, 5))]
PROGRAM = _ranges([("bitplanes.pack", 15, 95),
                   ("session.run_fused", 105, 590),
                   ("cuda.run_fused", 110, 580),
                   ("bitplanes.unpack", 605, 690),
                   ("sweep.fused_run", 920, 990)])


def _readings(t: TraceData) -> dict:
    times = np.arange(-5, 1010, 5, dtype=np.int64)
    out = {"names": t.names, "start": t.start.tolist(),
           "end": t.end.tolist(), "launch": t.launch.tolist(),
           "spans": t.spans, "window": t.window,
           "span_at": t.span_at(times), "breakdown": t.breakdown(),
           "busy_s": t.busy_s()}
    for prefix in ("bench.", "bench.pack", "bench.run_fused",
                   "bench.unpack", "bench.wait"):
        out[prefix] = t.launched_in(prefix).tolist()
    counters = {"mode": "megakernel", "image_bytes": 2e6, "maj_bytes": 1e6}
    for mode in ("megakernel", "fused"):
        rec = Record(window_s=1.0, attempted=2, failed=0,
                     latencies_s=[0.1, 0.2],
                     work={"requests": 2, "lanes": 64},
                     counters=dict(counters, mode=mode), trace=t)
        for m in FULL["per_layer"]:
            if m["source"] == "device_trace":
                out[mode, m["name"]] = metric_reader(m["name"]).read(rec)
    return out


def test_program_spans_change_no_reading():
    plain = TraceData.from_events(BENCH + LAUNCHES + DEVICE)
    spanned = TraceData.from_events(BENCH + PROGRAM + LAUNCHES + DEVICE)
    assert _readings(spanned) == _readings(plain)
    # What the readers read there: the `bench.*` spans, not the program's.
    assert spanned.launched_in("bench.run_fused").tolist() == [
        False, True, True, False, False]
    assert spanned.span_at(np.asarray([50, 300, 950])) == [
        "bench.pack", "bench.run_fused", OUTSIDE]
    assert {n for _, _, n in spanned.spans} == {
        "bench.pack", "bench.run_fused", "bench.unpack", "bench.wait"}
    r = _readings(spanned)
    assert r["megakernel", "megakernel_roofline"] is not None
    assert r["fused", "majx_roofline.arith"] is not None


def test_profiled_program_spans_stay_out_of_the_trace():
    """A real (CPU) profiler window: the port's spans are annotations in
    the events, and the harness keeps only its own."""
    from torch.profiler import record_function

    from repro_torch.backends import ExecutionContext
    from repro_torch.backends.cuda import CudaBackend
    from repro_torch.compile.trace import compile_elementwise
    from repro_torch.core import bitplanes as bp
    from repro_torch.session import DramSession

    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 2**32, 64, dtype=np.uint32) for _ in "ab")
    cp = compile_elementwise("add", a, b, tier=5, n_act=32)
    session = DramSession(CudaBackend(ExecutionContext(device="cpu")))
    state = torch.from_numpy(cp.state.view(np.int32))
    with Profiler(True) as prof:
        with record_function("bench.window"):
            with record_function("bench.pack"):
                bp.pack_uint_elements(torch.from_numpy(a.view(np.int32)))
            with record_function("bench.run_fused"):
                session.run_fused(cp.program, state, mode="fused")
    assert [n for _, _, n in prof.data.spans] == ["bench.pack",
                                                  "bench.run_fused"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_runs_open_no_recording(monkeypatch, trace):
    """Spans are made only under the traced window's profiler; no run
    opens a recording, so the timed windows pay the flag checks alone."""
    from repro_torch import obs

    made = []
    init = obs._Span.__init__

    def spy(self, name):
        made.append((name, obs._profiling(), obs._window))
        init(self, name)

    monkeypatch.setattr(obs._Span, "__init__", spy)
    profiled = []
    enter = Profiler.__enter__

    def spy_enter(self):
        if self.enabled:
            profiled.append(len(made))
        return enter(self)

    monkeypatch.setattr(Profiler, "__enter__", spy_enter)
    cell = ARITH[0]
    res = runner.run_cell(cell, SEED, 1.0, trace, device="cpu",
                          overrides=SMALL, spec=FULL,
                          out=open(os.devnull, "w"))
    assert res["correct"]
    assert all(opened is None for _, _, opened in made)
    assert all(profiling for _, profiling, _ in made)
    if trace:
        assert profiled and not made[:profiled[0]]
        assert {"bitplanes.pack", "session.run_fused", "cuda.run_fused",
                "bitplanes.unpack"} <= {n for n, _, _ in made}
    else:
        assert made == []
