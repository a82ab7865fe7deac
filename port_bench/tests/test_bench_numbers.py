"""The benchmark's arithmetic on synthetic inputs: rates, tails over all
requests, spreads, bytes bounds, roofline shares, the busy union, idle
gaps by span, and the traffic generator."""

from __future__ import annotations

import collections
import statistics

import numpy as np
import pytest

from port_bench.tests._util import SEED
from port_bench.harness import peaks, stats, traffic
from port_bench.harness.record import Record
from port_bench.harness.spec import metric_reader
from port_bench.harness.trace import OUTSIDE, TraceData


@pytest.mark.parametrize("p", [50, 90, 95, 99])
def test_percentile_over_all_values(p):
    xs = np.random.default_rng(p).exponential(size=997).tolist()
    assert stats.percentile(xs, p) == pytest.approx(np.percentile(xs, p))


def test_tail_is_not_a_median_of_chunk_tails():
    xs = [1.0] * 95 + [100.0] * 5
    chunked = statistics.median(stats.percentile(xs[i:i + 10], 95)
                                for i in range(0, 100, 10))
    assert stats.percentile(xs, 95) > 5 * chunked


def test_rate():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_bytes_bounds():
    assert peaks.image_bytes(161, 2**20) == 2 * 161 * 2**20 * 4
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.share_percent(3.35e9, 2e-3) == pytest.approx(50.0)
    assert peaks.share_percent(1, 0.0) is None

    class Op:
        def __init__(self, kind, srcs, dsts):
            self.kind, self.srcs, self.dsts = kind, srcs, dsts

    class Prog:
        ops = [Op("MAJ", (1, 2, 3), (4,)), Op("NOT", (4,), (5,)),
               Op("MAJ", (1, 2, 3, 4, 5), (6,))]
    assert peaks.maj_op_bytes(Prog, 8) == (4 + 6) * 8 * 4


def trace(device, spans, window=(0, 100)):
    names = [n for n, *_ in device]
    return TraceData(names,
                     np.asarray([s for _, s, _, _ in device], np.int64),
                     np.asarray([e for _, _, e, _ in device], np.int64),
                     np.asarray([ln for *_, ln in device], np.int64),
                     sorted(spans), window)


def test_busy_union_and_idle_gaps_by_span():
    t = trace([("k1", 10, 30, 5), ("k2", 20, 40, 16), ("copy", 60, 70, 55)],
              [(0, 55, "bench.run_fused"), (5, 15, "bench.pack"),
               (55, 100, "bench.wait")])
    assert t.union() == [(10, 40), (60, 70)]
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.gaps() == [(0, 10), (40, 60), (70, 100)]
    assert t.span_at(np.asarray([7, 20, 55, 200])) == [
        "bench.pack", "bench.run_fused", "bench.wait", OUTSIDE]
    assert t.launched_in("bench.pack").tolist() == [True, False, False]
    assert t.device_s(name_has="k") == pytest.approx(40e-9)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    gaps = dict(b["idle_gaps"])
    assert gaps["bench.pack"] == pytest.approx(10e-9)
    assert gaps["bench.wait"] == pytest.approx(30e-9)
    assert gaps["bench.run_fused"] == pytest.approx(20e-9)


def test_idle_and_roofline_readers():
    t = trace([("megakernel_resident", 0, 50, 1), ("copy", 50, 60, 2)],
              [(0, 100, "bench.run_fused")], window=(0, 200))
    rec = Record(window_s=2.0, attempted=4, failed=0,
                 latencies_s=[0.1, 0.2, 0.3, 0.4],
                 work={"requests": 4, "lanes": 1000},
                 counters={"mode": "megakernel", "image_bytes": 3.35e3 * 30,
                           "maj_bytes": 0},
                 trace=t)
    assert metric_reader("device_idle.arith").read(rec) == \
        pytest.approx(70.0)
    assert metric_reader("device_ops_per_req").read(rec) == 0.5
    # 100.5 us of bytes over 60 ns of device work... scaled: share in %.
    share = metric_reader("megakernel_roofline").read(rec)
    assert share == pytest.approx(100 * (3.35e3 * 30 / 3.35e12) / 60e-9)
    rec.trace.launch[1] = -1
    assert metric_reader("megakernel_roofline").read(rec) is None
    assert metric_reader("arith_lanes_per_s").read(rec) == 500.0
    assert metric_reader("arith_p95_ms").read(rec) == \
        pytest.approx(385.0)
    assert metric_reader("serve_req_per_s").read(rec) is None
    assert metric_reader("arith_io_roofline").read(rec) == \
        pytest.approx(100 * 1000 * 12 / 3.35e12 / 2.0)


def test_readers_find_nothing_without_a_trace():
    rec = Record(window_s=1.0, attempted=1, failed=0, latencies_s=[0.1],
                 work={"requests": 1})
    for name in ("device_idle.serve", "majx_roofline.serve",
                 "device_ops_per_req", "megakernel_roofline",
                 "serve_queue_ms", "serve_batch_ms", "run_fused_host_ms"):
        assert metric_reader(name).read(rec) is None


def test_mix_has_the_same_kinds_whatever_the_seed():
    mix = {"add": 1, "sub": 1, "mul": 1}
    firsts = set()
    for seed in (1, 2**40 + 3, SEED):
        seq = traffic.mix_sequence(mix, 10, seed)
        ops = [next(seq) for _ in range(30 * 400)]
        for deal in range(0, len(ops), 30):
            assert collections.Counter(ops[deal:deal + 30]) == {
                "add": 10, "sub": 10, "mul": 10}
        # Neighbours as good as independent: mul follows mul with
        # probability 1/3 * 9/29 inside a deal (1/9 for independent draws).
        pairs = sum(a == b == "mul" for a, b in zip(ops, ops[1:]))
        assert pairs / (len(ops) - 1) == pytest.approx(0.104, abs=0.012)
        firsts.add(tuple(ops[:30]))
        again = traffic.mix_sequence(mix, 10, seed)
        assert [next(again) for _ in range(len(ops))] == ops
    assert len(firsts) == 3


def test_metric_reader_falls_back_to_the_quantity():
    assert metric_reader("majx_roofline.serve") is \
        metric_reader("majx_roofline.arith")
    assert metric_reader("device_idle.serve") is \
        metric_reader("device_idle")


def test_sub_seeds_and_reservoir():
    assert traffic.sub_seed(SEED, 1) != traffic.sub_seed(SEED, 2)
    assert traffic.sub_seed(2**40, 0) < 2**63
    counts = collections.Counter()
    for s in range(400):
        r = traffic.Reservoir(2, s)
        for i in range(10):
            r.offer(lambda i=i: i)
        counts.update(r.items)
        assert len(r.items) == 2
    assert min(counts.values()) > 40      # each of 10 kept ~80 times
    order = traffic.pool_order(5, SEED, 1)
    assert sorted(next(order) for _ in range(5)) == list(range(5))
    assert traffic.tenants({"heal": 2, "erase": 1}) == [
        ("erase", 0), ("heal", 0), ("heal", 1)]
