"""The paper's figures, the kernel bench and the printer against the
reference's ``benchmarks/``, on the CPU.

Both packages run in this one process, each on a sweep store of its own
under a temporary root (the stochastic sim masks fold Python's per-
process string hash in, ROADMAP queue 3; these figures are analytic, so
they would agree across processes too).  The reference's Pallas kernels
run in interpret mode.  Fig 16's 28 traced programs take the reference
about 100 s, so it is compared on three ops here; its whole table is
held through ``chip_smoke.py``'s frozen rows, which equal the port's
output here and the reference's where this file computes it.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from repro_torch.paper import figures as F
from repro_torch.paper import kernel_bench as KB
from repro_torch.paper import run as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Figures whose rows are compared whole, string for string.
WHOLE = ("fig3_simra_timing", "fig4_simra_temp_vpp", "fig5_power",
         "fig6_maj3_timing", "fig6_cliff_adaptive", "fig7_majx_patterns",
         "fig8_majx_temperature", "fig9_majx_voltage", "fig10_mrc_timing",
         "fig11_mrc_patterns", "fig12_mrc_temp_vpp", "fig15_spice_mc",
         "fig17_cold_boot", "table1_devices")
#: Fig 16's ops compared against the reference (fast to trace).
FIG16_OPS = ("and", "xor", "add")


@contextlib.contextmanager
def _on_path(path):
    sys.path.insert(0, path)
    try:
        yield
    finally:
        sys.path.remove(path)


def _reference(module: str):
    import importlib

    with _on_path(REPO):
        return importlib.import_module(f"benchmarks.{module}")


@pytest.fixture(scope="module")
def pf(tmp_path_factory):
    """The reference's ``paper_figures`` over a temporary sweep root."""
    mod = _reference("paper_figures")
    saved = mod.SWEEP_ROOT
    mod.SWEEP_ROOT = str(tmp_path_factory.mktemp("ref_sweeps"))
    yield mod
    mod.SWEEP_ROOT = saved


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_sweeps"))


@pytest.fixture(scope="module")
def ref_figs(pf):
    """The reference's rows of each figure compared whole."""
    return {name: getattr(pf, name)() for name in WHOLE}


@pytest.fixture(scope="module")
def port_csv(port_root, tmp_path_factory):
    """``python -m repro_torch.paper.run --device cpu``'s lines (a fresh
    sweep root, no dry-run file)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert R.main(["--device", "cpu", "--root", port_root, "--results",
                       str(tmp_path_factory.mktemp("no_dryrun"))]) == 0
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def ref_fig18(pf):
    return pf.fig18_energy_modes()


@pytest.fixture(scope="module")
def ref_kernel_rows():
    return _reference("kernel_bench").kernel_benchmarks()


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";"))


@pytest.mark.parametrize("name", WHOLE)
def test_figure_rows_equal_the_reference(name, ref_figs, port_root):
    assert getattr(F, name)(root=port_root, device="cpu") == ref_figs[name]


def _fig16_rows(time_ns):
    """The reference's Fig 16 loop over :data:`FIG16_OPS` (averages over
    the three), each op's modelled time from ``time_ns(op, mfr, tier)``."""
    rows = []
    for mfr in ("M", "H"):
        tiers = (5, 7) if mfr == "M" else (5, 7, 9)
        speedups = {t: [] for t in tiers}
        for op in FIG16_OPS:
            base = time_ns(op, mfr, 3)
            for t in tiers:
                sp = base / time_ns(op, mfr, t)
                speedups[t].append(sp)
                rows.append((f"fig16_{mfr}_{op}_maj{t}", 0.0,
                             f"speedup={sp:.3f}"))
        for t in tiers:
            rows.append((f"fig16_{mfr}_avg_maj{t}", 0.0,
                         f"speedup={np.mean(speedups[t]):.3f}"))
    return rows


@pytest.fixture(scope="module")
def ref_fig16(pf):
    return _fig16_rows(pf._microbench_time_ns)


def test_fig16_equals_the_reference_on_three_ops(ref_fig16):
    """The port's modelled times in the reference's loop; the port's
    whole table is held through ``chip_smoke.py``'s frozen rows."""
    assert _fig16_rows(lambda op, mfr, tier: F._microbench_time_ns(
        op, mfr, tier, "cpu")) == ref_fig16


def test_fig18_dispatches_and_dram_energy_equal_the_reference(ref_fig18,
                                                              port_root):
    """The ``cuda`` session makes the reference ``pallas`` session's
    dispatches in each mode, and the in-situ DRAM energy is the
    reference's; the launch energies are the H100 CostModel's, so they
    are not the reference's TPU figures."""
    from repro_torch.core.costmodel import COST

    got = F.fig18_energy_modes(root=port_root, device="cpu")
    assert [r[0] for r in got] == [r[0] for r in ref_fig18]
    for (name, _, g), (_, _, w) in zip(got, ref_fig18):
        if name.endswith("_pud_dram"):
            assert g == w, name
        elif name.endswith(("_per_op", "_fused", "_megakernel")):
            assert _fields(g)["dispatches"] == _fields(w)["dispatches"], name
    counts = {n: int(_fields(d)["dispatches"]) for n, _, d in got
              if "dispatches" in d}
    assert counts["fig18_add32_fused"] == 34
    assert counts["fig18_add32_megakernel"] == 1
    assert got[-1][2] == f"per_launch={COST.dispatch_energy_nj(1):.1f}"


def test_kernel_bench_names_and_traffic_equal_the_reference(
        ref_kernel_rows):
    """The five rows, named by the ``cuda`` backend where the reference
    names ``pallas``; the bytes and batch fields the reference gives are
    the port's, and each bound is the bytes over the H100's 3.35 TB/s."""
    got = KB.kernel_benchmarks(device="cpu")
    assert [r[0] for r in got] == [r[0].replace("[pallas]", "[cuda]")
                                   for r in ref_kernel_rows]
    for (name, us, g), (_, _, w) in zip(got, ref_kernel_rows):
        g, w = _fields(g), _fields(w)
        assert us > 0
        for key in ("hbm_read_bytes", "write", "native_batch",
                    "traffic_reduction"):
            assert g.get(key) == w.get(key), (name, key)
        if "tpu_bytes" in w:
            assert g["bytes"] == w["tpu_bytes"]
        assert float(g["h100_bound_us"]) == pytest.approx(
            float(g["bytes"]) / 3.35e12 * 1e6, abs=5e-4)


def test_printer_prints_the_reference_names_in_order(
        pf, ref_figs, ref_fig18, ref_kernel_rows, port_csv, monkeypatch):
    """``python -m repro_torch.paper.run --device cpu``'s CSV has the
    reference printer's header and row names, in its order (kernel rows
    named ``[cuda]``); with no dry-run file, no roofline row.  The
    reference's ``benchmarks/run.py`` prints here the rows computed once
    in this file, and Fig 16 with every speedup 1 (so it traces
    nothing: its names do not depend on the times)."""
    for name, rows in ref_figs.items():
        monkeypatch.setattr(pf, name, lambda rows=rows: rows)
    monkeypatch.setattr(pf, "_microbench_time_ns", lambda *a, **k: 1.0)
    monkeypatch.setattr(pf, "fig18_energy_modes", lambda: ref_fig18)
    kb = _reference("kernel_bench")
    monkeypatch.setattr(kb, "kernel_benchmarks", lambda: ref_kernel_rows)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _reference("run").main()
    want = [ln.split(",")[0] for ln in out.getvalue().splitlines()]
    assert want[0] == "name" and not any(n.startswith("roofline_")
                                         for n in want)
    assert port_csv[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in port_csv] == [
        n.replace("[pallas]", "[cuda]") for n in want]


def _cell(arch, shape, status="ok", **roofline):
    row = {"arch": arch, "shape": shape, "mesh": "16x16", "status": status}
    if status == "ok":
        row["roofline"] = {"bottleneck": "memory", "roofline_fraction": 0.125,
                           "mem_per_chip_gb": 12.5, **roofline}
    return row


def test_roofline_rows_read_the_ports_dryrun_files(tmp_path):
    """One row an ``ok`` cell, in the reference's format; the files are
    the port's own names, never ``results/dryrun_*.json``; a malformed
    file raises where the reference's printer skips it."""
    cells = [_cell("chatglm3-6b", "train_4k"),
             _cell("gemma-7b", "long_500k", status="skipped")]
    (tmp_path / "torch_dryrun_single.json").write_text(json.dumps(cells))
    (tmp_path / "dryrun_single.json").write_text("not json")
    got = R.dryrun_rows(str(tmp_path))
    assert got == [("roofline_chatglm3-6b_train_4k_16x16", 0.0,
                    "bound=memory;frac=0.1250;mem_gb=12.50")]
    (tmp_path / "torch_dryrun_multi.json").write_text(
        json.dumps([{"arch": "a", "shape": "s", "status": "ok"}]))
    with pytest.raises(ValueError, match="malformed"):
        R.roofline_rows(str(tmp_path / "torch_dryrun_multi.json"))
    (tmp_path / "torch_dryrun_multi.json").write_text("{}")
    with pytest.raises(ValueError, match="list of cells"):
        R.roofline_rows(str(tmp_path / "torch_dryrun_multi.json"))


def _chip_smoke():
    with _on_path(REPO):
        import chip_smoke
    return chip_smoke


def test_chip_smoke_frozen_rows_are_the_references(ref_figs, ref_fig18,
                                                   ref_fig16, port_csv):
    """``chip_smoke.py``'s frozen rows (the printer's row names in order,
    each with its deterministic ``derived``: Fig 18's dispatches and
    DRAM energy, every other figure whole) equal the port's CPU output,
    Fig 16's whole table included, and the reference's output for every
    figure this file runs whole, Fig 16 on its three ops, and Fig 18."""
    smoke = _chip_smoke()
    port = [ln.split(",", 2) for ln in port_csv[1:]]
    assert list(smoke.PAPER_ROWS.items()) == [
        (n, smoke.paper_frozen(n, d)) for n, _, d in port]
    ref = [r for rows in ref_figs.values() for r in rows] + ref_fig18
    ref += [r for r in ref_fig16 if "_avg_" not in r[0]]
    for n, _, d in ref:
        assert smoke.PAPER_ROWS[n] == smoke.paper_frozen(n, d), n
    assert sum(v is not None for v in smoke.PAPER_ROWS.values()) == 274
