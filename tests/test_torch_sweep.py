"""The port's characterization sweep against the reference's.

``repro_torch.sweep`` is held to ``repro.sweep`` on the CPU: the same
grids, chunk keys and shards; records point for point for ``oracle``,
``sim`` (ideal and stochastic, in one process) and ``analytic``, and for
``cuda`` (its CUDA-less route) against ``pallas`` (interpret) apart from
the ``backend`` field; the same aggregates; resume, sharding, the store
and the CLI as ``tests/test_sweep.py`` exercises them in the reference.
Store names differ by design: the port's spec hash folds in the
fingerprint of its own calibration and error-model sources.
"""

import contextlib
import hashlib
import inspect
import io
import json
import os

import pytest

import repro.sweep as ref
import repro_torch.sweep as port
from repro.analyze.__main__ import main as ref_analyze
from repro.sweep.run import main as ref_cli
from repro_torch.analyze.__main__ import main as port_analyze
from repro_torch.sweep import runner as port_runner
from repro_torch.sweep import spec as port_spec
from repro_torch.sweep.run import main as port_cli

TINY = dict(x_values=(3,), n_act=(4, 32), ideal=True, rows=2, words=16,
            chunk=2)
CPU = dict(device="cpu")


def ref_name(backend: str) -> str:
    return "pallas" if backend == "cuda" else backend


def specs(**kw):
    """The reference's spec and the port's, built from the same grid
    (``cuda`` in the port where the reference has ``pallas``)."""
    backends = kw.pop("backends", ("sim",))
    return (ref.SweepSpec(backends=tuple(map(ref_name, backends)), **kw),
            port.SweepSpec(backends=backends, **kw))


def ref_json(r) -> dict:
    """The reference spec's JSON as the port writes it: without the
    Pallas ``interpret`` flag, ``cuda`` where it has ``pallas``."""
    raw = json.loads(r.to_json().replace('"pallas"', '"cuda"'))
    raw.pop("interpret")
    return raw


def as_ref(records):
    return [dict(r, backend=ref_name(r["backend"])) for r in records]


def run_both(tmp_path, **kw):
    r, p = specs(**kw)
    want = ref.run_sweep(r, str(tmp_path / "ref")).records
    got = port.run_sweep(p, str(tmp_path / "port"), **CPU).records
    return want, got


# ------------------------------------------------------------ spec / grid


def test_spec_json_and_grid_equal_reference():
    for kw in (dict(name="s", backends=("sim", "cuda"), **TINY),
               dict(name="m", op="mrc", backends=("cuda",), n_act=(2, 32),
                    patterns=("0x00", "random"), words=16),
               dict(name="t", op="simra", backends=("analytic",),
                    n_act=(8, 32), timings=((1.5, 3.0), (3.0, 3.0)))):
        r, p = specs(**kw)
        assert json.loads(p.to_json()) == ref_json(r)
        assert port.SweepSpec.from_json(p.to_json()) == p
        assert [(pt.index, pt.x, pt.n_act, pt.n_dest, pt.pattern, pt.t1)
                for pt in p.points()] == \
            [(pt.index, pt.x, pt.n_act, pt.n_dest, pt.pattern, pt.t1)
             for pt in r.points()]
        assert [c.key for c in port.plan(p)] == [c.key for c in ref.plan(r)]
        for n in (1, 2, 3):
            for i in range(n):
                assert [c.key for c in port.shard(port.plan(p), n, i)] == \
                    [c.key for c in ref.shard(ref.plan(r), n, i)]
        for axis in port.SEARCH_AXES:
            assert p.axis_values(axis) == r.axis_values(axis)
        assert p.searchable_axes() == r.searchable_axes()


def test_fingerprint_is_the_ports_physics_sources(monkeypatch):
    """The decision pinned: the spec hash folds in the sha256 of the
    port's own ``calibration.py`` + ``errormodel.py`` source text, so an
    edit to an anchor or a surface orphans every store, and no port store
    is named like the reference's even where the JSON is identical."""
    from repro_torch.core import calibration, errormodel

    src = inspect.getsource(calibration) + inspect.getsource(errormodel)
    assert port_spec._model_fingerprint() == \
        hashlib.sha256(src.encode()).hexdigest()[:8]
    r, p = specs(name="fp", **TINY)
    assert json.loads(p.to_json()) == ref_json(r)
    assert p.spec_hash() != r.spec_hash()
    assert p.spec_hash() == p.replace().spec_hash()
    assert p.spec_hash() != p.replace(n_act=(32,)).spec_hash()
    old = p.spec_hash()
    monkeypatch.setattr(port_spec, "_model_fingerprint", lambda: "0badcafe")
    assert p.spec_hash() != old and p.store_name().endswith(p.spec_hash())


@pytest.mark.parametrize("bad,match", [
    (dict(n_act=(6,)), "not reachable"),
    (dict(op="majx", patterns=("0x00",)), "patterns"),
    (dict(x_values=(4,)), "odd"),
    (dict(backends=("pallas",)), "unknown backends"),
    (dict(op="simra", backends=("sim",)), "analytic-only"),
    (dict(op="nope"), "unknown op"),
    (dict(chunk=0), "chunk"),
])
def test_spec_rejects_what_the_reference_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        port.SweepSpec(name="bad", **bad)
    if "pallas" not in str(bad):
        with pytest.raises(ValueError, match=match):
            ref.SweepSpec(name="bad", **bad)
    else:                          # the reference has no "cuda" instead
        with pytest.raises(ValueError, match=match):
            ref.SweepSpec(name="bad", backends=("cuda",))


# ----------------------------------------------------------- record parity


@pytest.mark.parametrize("ideal", [True, False],
                         ids=["ideal", "stochastic"])
def test_majx_records_equal_reference(tmp_path, ideal):
    want, got = run_both(
        tmp_path, name="par", backends=("oracle", "sim", "cuda", "analytic"),
        x_values=(3, 5), n_act=(4, 8, 32), patterns=("random", "0x00/0xFF"),
        rows=2, words=16, chunk=3, ideal=ideal, seeds=(0, 1))
    assert len(got) == 2 * 2 * 5 * 4
    assert as_ref(got) == want


@pytest.mark.parametrize("ideal", [True, False],
                         ids=["ideal", "stochastic"])
def test_mrc_records_equal_reference(tmp_path, ideal):
    want, got = run_both(
        tmp_path, name="mrc", op="mrc",
        backends=("oracle", "sim", "cuda", "analytic"), n_act=(2, 8, 32),
        patterns=("0x00", "0xFF", "random"), words=16, chunk=4,
        ideal=ideal, temps_c=(50.0, 80.0))
    assert as_ref(got) == want


def test_env_and_timing_records_equal_reference(tmp_path):
    want, got = run_both(
        tmp_path, name="env", backends=("sim", "analytic"), x_values=(3,),
        n_act=(8,), timings=((1.5, 3.0), (3.0, 3.0)), temps_c=(50.0, 90.0),
        vpps_v=(2.5, 2.1), rows=1, words=16, chunk=4, mfrs=("H", "M"))
    assert as_ref(got) == want


@pytest.mark.parametrize("fig", sorted(ref.presets.FIGURE_SPECS))
def test_figure_presets_equal_reference(tmp_path, fig):
    r = ref.presets.FIGURE_SPECS[fig]()
    p = port.presets.FIGURE_SPECS[fig]()
    assert json.loads(p.to_json()) == ref_json(r)
    got = port.run_sweep(p, str(tmp_path / "p"), **CPU).records
    assert got == ref.run_sweep(r, str(tmp_path / "r")).records
    assert port.aggregate.headline(got) == ref.aggregate.headline(got)


def test_fused_chunks_are_one_launch_each(tmp_path):
    """A multi-point ``cuda`` chunk runs as one fused Program: one MAJX
    dispatch, plus one mismatch count a point."""
    from repro_torch.backends.cuda import CudaBackend

    calls = []
    orig = CudaBackend.run_fused

    def counted(self, *a, **kw):
        before = self.dispatch_count
        out = orig(self, *a, **kw)
        calls.append(self.dispatch_count - before)
        return out

    spec = port.SweepSpec(name="fused", backends=("cuda",), x_values=(3, 5),
                          n_act=(8, 32), patterns=("random", "0xCC/0x33"),
                          rows=3, words=16, chunk=3)
    CudaBackend.run_fused = counted
    try:
        records = port.run_sweep(spec, str(tmp_path), **CPU).records
    finally:
        CudaBackend.run_fused = orig
    sizes = [len(c.points) for c in port.plan(spec)]
    assert calls == [1] * sum(1 for n in sizes if n > 1)
    assert all(r["success"] == 1.0 for r in records)


def test_counts_stay_under_the_int32_wrap(monkeypatch):
    """``_success`` counts in slices (2**31 bits at most each); a small
    slice gives the same count as one."""
    import torch

    from repro_torch.core import bitplanes as bp

    g = torch.Generator().manual_seed(0)
    a = torch.randint(-2**31, 2**31 - 1, (5, 37), generator=g,
                      dtype=torch.int32)
    b = torch.randint(-2**31, 2**31 - 1, (5, 37), generator=g,
                      dtype=torch.int32)
    from repro_torch.kernels.mismatch.ref import mismatch_count_ref

    def count(x, y):
        return mismatch_count_ref(x, y)
    whole = port_runner._success(a, b, count)
    monkeypatch.setattr(port_runner, "_COUNT_WORDS", 7)
    assert port_runner._success(a, b, count) == whole
    bad = int(bp.popcount(a ^ b).sum())
    assert whole == (1.0 - bad / (a.numel() * 32), a.numel() * 32)


# ----------------------------------------------------- execution / resume


def test_resume_after_kill_recomputes_nothing(tmp_path):
    spec = port.SweepSpec(name="kill", backends=("sim", "cuda"),
                          patterns=("random", "0x00/0xFF"), **TINY)
    partial = port.run_sweep(spec, str(tmp_path / "a"), max_chunks=1, **CPU)
    assert partial.executed_chunks == 1 and partial.pending_chunks > 0
    resumed = port.run_sweep(spec, str(tmp_path / "a"), **CPU)
    assert resumed.cached_chunks == 1
    assert resumed.executed_chunks == len(port.plan(spec)) - 1
    again = port.run_sweep(spec, str(tmp_path / "a"), **CPU)
    assert again.executed_chunks == 0 and again.records == resumed.records
    assert resumed.records == port.run_sweep(spec, str(tmp_path / "b"),
                                             **CPU).records


def test_resume_invalidated_by_fingerprint_change(tmp_path, monkeypatch):
    spec = port.SweepSpec(name="fp", backends=("sim",), **TINY)
    first = port.run_sweep(spec, str(tmp_path), **CPU)
    monkeypatch.setattr(port_spec, "_model_fingerprint", lambda: "0badcafe")
    second = port.run_sweep(spec, str(tmp_path), **CPU)
    assert second.executed_chunks == first.executed_chunks
    assert second.cached_chunks == 0
    assert second.store_path != first.store_path
    assert port.run_sweep(spec, str(tmp_path), **CPU).executed_chunks == 0


def test_sharded_stochastic_records_independent_of_history(tmp_path):
    spec = port.SweepSpec(name="det", backends=("sim",), x_values=(3, 5),
                          n_act=(32,), rows=2, words=32, chunk=1)
    base = port.run_sweep(spec, str(tmp_path / "base"), **CPU).records
    port.run_sweep(spec, str(tmp_path / "sh"), num_shards=2, shard_index=1,
                   **CPU)
    part = port.run_sweep(spec, str(tmp_path / "sh"), num_shards=2,
                          shard_index=0, **CPU)
    assert part.pending_chunks == 0 and part.records == base
    r, _ = specs(name="det", backends=("sim",), x_values=(3, 5),
                 n_act=(32,), rows=2, words=32, chunk=1)
    assert base == ref.run_sweep(r, str(tmp_path / "ref")).records


def test_stochastic_sim_tracks_calibration(tmp_path):
    """The reference's bound (``tests/test_sweep.py``), on the port."""
    spec = port.SweepSpec(name="stoch", backends=("sim",), x_values=(3,),
                          n_act=(4, 32), rows=2, words=64, chunk=8)
    records = port.run_sweep(spec, str(tmp_path), **CPU).records
    for r in records:
        assert r["success"] == pytest.approx(r["expected"], abs=0.05)
    assert port.aggregate.replication_delta(records) > 0.15


def test_memory_store_and_self_describing_chunks(tmp_path):

    spec = port.SweepSpec(name="mem", backends=("sim", "cuda"), **TINY)
    mem = port.RecordStore("", spec, backend=port.MemoryBackend("t"))
    in_mem = port.run_sweep(spec, store=mem, **CPU).records
    on_disk = port.run_sweep(spec, str(tmp_path), **CPU)
    assert in_mem == on_disk.records
    with open(os.path.join(on_disk.store_path, "spec.json")) as f:
        assert port.SweepSpec.from_json(f.read()) == spec
    chunk_dir = os.path.join(on_disk.store_path, "chunks")
    for name in sorted(os.listdir(chunk_dir)):
        with open(os.path.join(chunk_dir, name)) as f:
            payload = json.load(f)
        assert payload["indices"] == [r["index"]
                                      for r in payload["records"]]
    found = [s for s, _ in port.discover(str(tmp_path))]
    assert found == [spec]


def test_aggregates_equal_reference(tmp_path):
    want, got = run_both(
        tmp_path, name="agg", backends=("sim", "analytic"),
        x_values=(3, 5), n_act=(4, 8, 32),
        patterns=("random", "0xAA/0x55"), temps_c=(50.0, 70.0),
        rows=1, words=32, chunk=4)
    for fn in (port.aggregate.headline, ref.aggregate.headline):
        assert fn(iter(got)) == fn(got)
    assert port.aggregate.headline(got) == ref.aggregate.headline(want)
    assert port.aggregate.success_table(got, ("backend", "x", "n_act")) == \
        ref.aggregate.success_table(want, ("backend", "x", "n_act"))
    assert port.aggregate.group_mean(got, ("pattern",)) == \
        ref.aggregate.group_mean(want, ("pattern",))


def test_mesh_and_workers_wait_for_their_port(tmp_path):
    """The mesh path and ``--workers`` are ported: a one-device mesh
    gives the plain run's records, and ``--workers 2`` runs the
    fault-tolerant runner (``tests/test_torch_ft.py`` holds both to the
    reference)."""
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(model=1, device="cpu")
    spec = port.SweepSpec(name="mesh", **TINY)
    assert port.run_sweep(spec, str(tmp_path / "m"), mesh=mesh,
                          **CPU).records == \
        port.run_sweep(spec, str(tmp_path / "plain"), **CPU).records
    aspec = port.AdaptiveSpec(base=spec.replace(n_act=(4, 32)))
    assert port.run_adaptive(aspec, str(tmp_path / "am"), mesh=mesh,
                             **CPU).records == \
        port.run_adaptive(aspec, str(tmp_path / "a"), **CPU).records
    rc, out = _run(port_cli, ["--smoke", "--workers", "2", "--root",
                              str(tmp_path), "--device", "cpu", "--quiet"])
    assert rc == 0 and out[0].startswith("ft-sweep 'smoke'")
    assert "across 2 workers" in out[0]


# --------------------------------------------------------------- adaptive


def test_adaptive_equals_reference(tmp_path):
    r = ref.presets.adaptive_smoke_spec()
    p = port.presets.adaptive_smoke_spec()
    want = ref.run_adaptive(r, str(tmp_path / "r"))
    got = port.run_adaptive(p, str(tmp_path / "p"), **CPU)
    assert got.records == want.records
    assert [c.describe() for c in got.crossings] == \
        [c.describe() for c in want.crossings]
    assert (got.n_probed, got.executed_chunks, got.complete) == \
        (want.n_probed, want.executed_chunks, want.complete)
    partial = port.run_adaptive(p, str(tmp_path / "k"), max_chunks=2, **CPU)
    assert not partial.complete
    done = port.run_adaptive(p, str(tmp_path / "k"), **CPU)
    assert done.complete and done.records == got.records
    base = p.base.replace(backends=("sim",), rows=1, words=16,
                          timings=p.base.timings[:6], name="ad-sim")
    rbase = r.base.replace(backends=("sim",), rows=1, words=16,
                           timings=r.base.timings[:6], name="ad-sim")
    got = port.run_adaptive(port.AdaptiveSpec(base=base),
                            str(tmp_path / "p"), **CPU)
    want = ref.run_adaptive(ref.AdaptiveSpec(base=rbase),
                            str(tmp_path / "r"))
    assert got.records == want.records


# ------------------------------------------------------------------- CLI


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_smoke_and_expect_cached(tmp_path):
    root = str(tmp_path)
    rc, out = _run(port_cli, ["--smoke", "--root", root, "--quiet",
                              "--device", "cpu"])
    assert rc == 0 and "2 chunks executed" in out[0]
    rc, cached = _run(port_cli, ["--smoke", "--root", root, "--quiet",
                                 "--device", "cpu", "--expect-cached"])
    assert rc == 0 and "0 chunks executed" in cached[0]
    assert cached[1:] == out[1:]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _ = _run(port_cli, ["--figure", "fig3", "--root", root,
                                "--quiet", "--expect-cached"])
    assert rc == 1 and "--expect-cached" in err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--smoke"], ["--figure", "fig6"], ["--adaptive"],
    ["--adaptive", "--figure", "fig6"], ["--smoke", "--backends",
                                         "oracle,sim"],
    ["--smoke", "--shards", "2", "--shard-index", "1"]])
def test_cli_prints_the_reference_aggregates(tmp_path, argv):
    """The CLI's lines past the summary (crossings, headlines, mean
    success per op and backend) are the reference's; the summary names
    the port's own store."""
    def norm(lines):
        return [ln.replace("pallas", "cuda") for ln in lines[1:]]

    rc_r, want = _run(ref_cli, argv + ["--root", str(tmp_path / "r"),
                                       "--quiet"])
    rc_p, got = _run(port_cli, argv + ["--root", str(tmp_path / "p"),
                                       "--quiet", "--device", "cpu"])
    assert rc_p == rc_r == 0
    assert norm(got) == norm(want)
    assert got[0].split("[")[0] == want[0].split("[")[0]


def test_cli_spec_file_and_list_figures(tmp_path):
    spec = port.SweepSpec(name="file", backends=("sim", "cuda"), **TINY)
    path = tmp_path / "spec.json"
    path.write_text(spec.to_json())
    rc, out = _run(port_cli, ["--spec", str(path), "--root",
                              str(tmp_path), "--quiet", "--device", "cpu"])
    assert rc == 0 and out[0].startswith("sweep 'file'")
    # A reference spec file (its ``interpret`` key included) loads.
    r, p = specs(name="file", **TINY)
    path.write_text(r.to_json())
    assert "interpret" in r.to_json() and port.load_spec(str(path)) == p
    rc, figs = _run(port_cli, ["--list-figures"])
    assert rc == 0 and figs == _run(ref_cli, ["--list-figures"])[1]


def test_analyzer_sweep_digests_equal_reference():
    rc_r, want = _run(ref_analyze, ["--sweep", "-v"])
    rc_p, got = _run(port_analyze, ["--sweep", "-v"])
    assert rc_p == rc_r == 0 and got == want
    assert got[0].startswith("OK   sweep/smoke/chunk-000000-000003")
