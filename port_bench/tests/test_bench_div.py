"""The division cell on the CPU at a small width: its reference, its
divisor law, its driver (a Program compiled once for any operands, a
recording a window), its control, and its two readers on synthetic
records."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from port_bench.tests._util import SEED, SMALL
from port_bench.control.run_control_div import control_checks
from port_bench.harness import runner
from port_bench.harness import spec as specs
from port_bench.harness.record import Record
from port_bench.harness.spec import load_cell, metric_reader
from port_bench.harness.trace import TraceData

CELL = "div2.megakernel"
LOADED = load_cell(CELL)
REF = specs.reference(LOADED.config)
DRV = specs.driver(LOADED.config)


def run(trace=False, seconds=1.0):
    return runner.run_cell(CELL, SEED, seconds, trace, device="cpu",
                           overrides=SMALL, out=open(os.devnull, "w"))


def test_cell_reports_its_metrics():
    assert LOADED.chips == 1
    assert LOADED.config_name == "simdram-div"
    assert LOADED.traffic_name == "closed2.div-megakernel"
    assert {m["name"] for m in LOADED.end_to_end} == {
        "arith_lanes_per_s", "arith_p95_ms", "setup_s"}
    assert {m["name"] for m in LOADED.per_layer} == {
        "run_fused_host_ms", "device_ops_per_req", "megakernel_roofline",
        "arith_io_roofline", "device_idle.arith", "megakernel_level_us",
        "session_keys_ms"}
    assert LOADED.config["ops"] == ["div"] and LOADED.config["banks"] == 2


def test_reference_against_python_ints():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    b = (rng.integers(0, 2**32, 4000, dtype=np.uint64)
         >> rng.integers(0, 33, 4000).astype(np.uint64)).astype(np.uint32)
    b[:5] = [0, 1, 2, 0xFFFFFFFF, 0x80000000]
    a[:5] = [7, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF]
    want = [0xFFFFFFFF if int(y) == 0 else int(x) // int(y)
            for x, y in zip(a, b)]
    assert REF.expected("div", a, b).tolist() == want
    assert REF.wrong_lanes("div", a, b, np.asarray(want, np.uint32)) == 0
    assert REF.wrong_lanes("div", a, b, np.asarray(want[:-1],
                                                   np.uint32)) == a.size
    with pytest.raises(ValueError):
        REF.expected("mul", a, b)


def test_control_is_wrong_on_large_quotients_alone():
    a = np.asarray([0xFFFFFFFF, 0x01000001, 100, 0x00FFFFFF, 9],
                   np.uint32)
    b = np.asarray([1, 1, 7, 0x100, 0], np.uint32)
    got = REF.control("div", a, b)
    want = REF.expected("div", a, b)
    # A quotient of more than 24 bits loses its low bits in float32.
    assert (got != want).tolist() == [True, True, False, False, False]
    assert got[4] == 0xFFFFFFFF


def test_divisors_from_the_seed():
    st = DRV.State(LOADED.config, LOADED.traffic, SEED, "cpu")
    st.lanes = 1 << 16
    a, b = st.operands(3)
    again = st.operands(3)
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])
    assert not torch.equal(b, st.operands(4)[1])
    u = DRV._u32(b).astype(np.int64)
    zeros = np.mean(u == 0)
    assert 0.04 < zeros < 0.08   # ~2/33: k = 32, and k past the top bit
    widths = np.floor(np.log2(np.maximum(u, 1))).astype(int) + 1
    assert set(range(1, 33)) <= set(widths[u > 0].tolist())
    assert DRV._u32(a).max() > 2**31      # the dividend stays uniform


def test_compiled_image_is_compile_op_s():
    from repro_torch.compile import compile_op

    prog = DRV.compile_div("div", LOADED.config)
    co = compile_op("div", 5, 32)
    assert prog.compiled.program == co.program and prog.rows == co.n_rows
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 2**32, 64 * 32, dtype=np.uint64)
            .astype(np.uint32) for _ in "ab")
    image = DRV.arith.template(prog, 64, torch.device("cpu"))
    image[prog.a_rows] = co.image(a, b)[list(co.a_rows)]
    image[prog.b_rows] = co.image(a, b)[list(co.b_rows)]
    assert torch.equal(image, co.image(a, b))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_small_run_is_correct_and_records_its_spans(trace):
    res = run(trace=trace)
    assert res["correct"], res["checks"]
    assert res["checks"]["wrong_lanes"]["value"] == 0
    assert res["checks"]["ops_not_compared"]["value"] == 0
    names = set(res["metrics"])
    if trace:
        # The CPU has no device trace: the host and program readers.
        assert {"run_fused_host_ms", "session_keys_ms",
                "arith_io_roofline"} <= names
        assert res["metrics"]["session_keys_ms"]["value"] > 0
    else:
        assert names == {"arith_lanes_per_s", "arith_p95_ms", "setup_s"}


def test_window_leaves_the_recording(monkeypatch):
    windows = []
    window = DRV.arith.window

    def spy(st, seconds, prof):
        rec = window(st, seconds, prof)
        windows.append(rec)
        return rec

    monkeypatch.setattr(DRV.arith, "window", spy)
    res = run()
    assert res["correct"] and len(windows) == 1
    program = windows[0].counters["program"]
    calls = program["spans"]["session.run_fused"]["calls"]
    assert calls == windows[0].attempted
    assert program["spans"]["session.program_key"]["calls"] == calls
    assert program["spans"]["cache.lowering_digest"]["calls"] == calls
    levels = program["counters"]["megakernel.levels"]
    assert levels % calls == 0 and levels // calls > 100


@pytest.mark.parametrize("fault", ["unchanged", "altered", "traced_div"])
def test_broken_div_path_is_not_correct(fault, monkeypatch):
    from repro_torch.compile import CompiledOp
    from repro_torch.session import DramSession

    if fault == "unchanged":
        def unchanged(self, program, state, **kw):
            return self.backend.words(state).clone()
        monkeypatch.setattr(DramSession, "run_fused", unchanged)
    elif fault == "altered":
        orig = CompiledOp.outputs

        def altered(self, final, n_lanes):
            out = orig(self, final, n_lanes).clone()
            out[0] ^= 1
            return out
        monkeypatch.setattr(CompiledOp, "outputs", altered)
    else:
        # The Program compile_elementwise traces on sample operands, with
        # its operand rows found by value, as the arith driver builds it.
        cfg = dict(LOADED.config, trace_words=64, trace_seed=0)
        monkeypatch.setattr(DRV, "compile_div",
                            lambda op, config: DRV.arith.trace_op(op, cfg))
    res = run()
    assert not res["correct"]
    assert res["checks"]["wrong_lanes"]["value"] > 0


def test_control_is_not_correct():
    checks = control_checks(CELL, SEED, "cpu", SMALL)
    assert checks["ops_not_compared"]["ok"]
    assert not checks["wrong_lanes"]["ok"]


def _trace(device, spans):
    return TraceData([n for n, *_ in device],
                     np.asarray([s for _, s, _, _ in device], np.int64),
                     np.asarray([e for _, _, e, _ in device], np.int64),
                     np.asarray([ln for *_, ln in device], np.int64),
                     sorted(spans), (0, 1000))


def test_level_reader():
    t = _trace([("megakernel_streaming", 100, 400, 10),
                ("Memcpy DtoD", 0, 100, 11),
                ("megakernel_streaming", 500, 700, 210),
                ("megakernel_streaming", 800, 900, 600)],
               [(0, 300, "bench.run_fused"), (300, 500, "bench.pack")])
    rec = Record(window_s=1.0, attempted=2, failed=0, latencies_s=[0.1],
                 counters={"program": {"counters":
                                       {"megakernel.levels": 10}}},
                 trace=t)
    # 300 + 200 ns inside bench.run_fused (the third launch is not).
    assert metric_reader("megakernel_level_us").read(rec) == \
        pytest.approx(1e6 * 500e-9 / 10)
    rec.trace.launch[1] = -1
    assert metric_reader("megakernel_level_us").read(rec) is None
    rec.trace.launch[1] = 11
    for counters in ({}, {"program": {"counters": {}}}):
        rec.counters = counters
        assert metric_reader("megakernel_level_us").read(rec) is None
    rec.counters = {"program": {"counters": {"megakernel.levels": 10}}}
    rec.trace = None
    assert metric_reader("megakernel_level_us").read(rec) is None


def test_session_keys_reader():
    spans = {"session.run_fused": {"calls": 4, "total_s": 1.0},
             "session.program_key": {"calls": 4, "total_s": 0.02},
             "cache.lowering_digest": {"calls": 4, "total_s": 0.1}}
    rec = Record(window_s=1.0, attempted=4, failed=0, latencies_s=[0.1],
                 counters={"program": {"spans": spans}})
    read = metric_reader("session_keys_ms").read
    assert read(rec) == pytest.approx(0.12 / 4 * 1e3)
    del spans["cache.lowering_digest"]
    assert read(rec) == pytest.approx(0.02 / 4 * 1e3)
    del spans["session.program_key"]
    assert read(rec) is None
    rec.counters = {}
    assert read(rec) is None
