"""The five examples and the dry-run drivers against the reference's
``examples/`` and ``results/`` scripts, on the CPU.

Each example runs in this process at the reference's own sizes
(``train_tiny_lm`` at 12 steps of its small config, as both are given
the same arguments), and its printed lines are held to the reference
example's: the ``pallas`` backend's name mapped to ``cuda``, times left
out, and the numbers that come from the cost model (the serve planner's
speedup) or from float rounding (a training loss) compared as stated
where they are.  Weights the reference draws from a jax key are carried
across (``interop``) where the printed lines depend on them.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           JAX_PLATFORMS="cpu")


def _load(path: str, name: str):
    """A script of the repository loaded as a module (no ``main`` run)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, REPO)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(REPO)
    return mod


def _printed(fn, *args, **kw) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue().splitlines()


def _mapped(lines) -> list:
    """``lines`` with the backend's name mapped and runs of spaces (the
    names' padding) closed up."""
    return [" ".join(ln.replace("pallas", "cuda").split()) for ln in lines]


def test_quickstart_prints_the_references_lines():
    """Every line, the registry's names sorted after the mapping."""
    from repro_torch.examples import quickstart

    want = _mapped(_printed(_load("examples/quickstart.py",
                                  "ref_quickstart").main))
    got = _mapped(_printed(quickstart.main, ["--device", "cpu"]))
    reg = re.compile(r"registry: \((.*)\)")

    def norm(ln):
        m = reg.search(ln)
        return reg.sub(f"registry: {sorted(m.group(1).split(', '))}", ln) \
            if m else ln

    assert [norm(ln) for ln in got] == [norm(ln) for ln in want]
    assert got[-1] == "quickstart OK"


def test_pud_arithmetic_prints_the_references_lines():
    """The op table (DRAM ops, exactness, modelled us) and the averages:
    MAJ9 on maker H degrades to 0.85x.  The reference's latency model
    traces its program again on every call; it runs here over a memo of
    its traces by (op, tier, activations), which the traced program
    depends on alone."""
    from repro_torch.examples import pud_arithmetic

    pf = _load("benchmarks/paper_figures.py", "ref_paper_figures_memo")
    session, traces = pf.DramSession, {}

    class Memo:
        def __init__(self, *a, **kw):
            self._s = session(*a, **kw)

        def elementwise(self, op, a, b, tier, n_act):
            if (op, tier, n_act) not in traces:
                traces[op, tier, n_act] = self._s.elementwise(
                    op, a, b, tier=tier, n_act=n_act)
            return traces[op, tier, n_act]

    pf.DramSession = Memo
    ref = _load("examples/pud_arithmetic.py", "ref_pud_arithmetic")
    ref._microbench_time_ns = pf._microbench_time_ns
    want = _printed(ref.main)
    got = _printed(pud_arithmetic.main, ["--device", "cpu"])
    assert got == want
    assert any("Mfr H MAJ9: avg 0.85x" in ln for ln in got)


def test_tmr_checkpoint_demo_prints_the_references_lines():
    from repro_torch.examples import tmr_checkpoint_demo

    want = _printed(_load("examples/tmr_checkpoint_demo.py",
                          "ref_tmr_demo").main)
    got = _printed(tmr_checkpoint_demo.main, ["--device", "cpu"])
    assert got == want
    assert "healed 1 replica(s), bit-exact=True" in got[2]


def test_serve_batch_prints_the_references_lines():
    """The reference's seed-0 Gemma carried across: the healed bits (the
    same flips, drawn by the port's threefry under the same keys), the
    integrity and the generated tokens are the reference's.  The
    planner's verdict is priced by the H100 CostModel (the reference's
    by the TPU's: there the accelerator wins, here PUD does) and the
    wall is a time: both left out."""
    import jax

    from repro.configs.registry import get_config
    from repro.models import model as RM
    from repro_torch import interop
    from repro_torch.examples import serve_batch

    params, _ = RM.init(jax.random.PRNGKey(0),
                        get_config("gemma-7b", smoke=True))
    want = _mapped(_printed(_load("examples/serve_batch.py",
                                  "ref_serve_batch").main))
    got = _mapped(_printed(serve_batch.main, ["--device", "cpu"],
                           params=interop.params_from_jax(
                               jax.tree.map(np.asarray, params), "cpu")))
    cut = [(re.compile(r"; planner says .*$"), ""),
           (re.compile(r" in [0-9.]+s$"), "")]

    def norm(ln):
        for pat, rep in cut:
            ln = pat.sub(rep, ln)
        return ln

    assert [norm(ln) for ln in got] == [norm(ln) for ln in want]
    assert "param integrity 100.0000%" in got[0]


def test_train_tiny_lm_prints_the_references_lines(monkeypatch):
    """12 steps of the small xLSTM from the reference's initial state
    (its seed-0 draw carried across), a failure at step 7 and a restart
    from scratch: the same lines; each loss within 2e-3 of the
    reference's (eager torch against jitted XLA drift in the last digits
    over the steps), times left out."""
    import jax

    from repro.configs.registry import get_config
    from repro.train.step import init_train_state as ref_init
    from repro_torch import interop
    from repro_torch.examples import train_tiny_lm
    from repro_torch.train import trainer

    argv = ["--small", "--steps", "12", "--fail-at", "7"]
    ref_state, _ = ref_init(jax.random.PRNGKey(0),
                            get_config("xlstm-125m", smoke=True))
    carried = interop.train_state_from_jax(
        jax.tree.map(np.asarray, ref_state), "cpu")
    monkeypatch.setattr(trainer, "init_train_state",
                        lambda key, cfg, device: (carried, None))
    got = _printed(train_tiny_lm.main, argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train_tiny_lm.py"] + argv)
    want = _printed(_load("examples/train_tiny_lm.py", "ref_train").main)
    num = re.compile(r"-?\d+\.\d{4}")
    ms = re.compile(r" \(\d+ ms\)$")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = ms.sub("", g), ms.sub("", w)
        assert num.sub("#", g) == num.sub("#", w)
        for a, b in zip(num.findall(g), num.findall(w)):
            assert abs(float(a) - float(b)) <= 2e-3, (g, w)
    assert "FAILURE: node_loss at step 7" in "\n".join(got)


# ------------------------------------------------------------- drivers


@pytest.fixture(scope="module")
def ref_cells():
    return _load("results/run_all_cells.py", "ref_run_all_cells")


def test_run_all_cells_tables_equal_the_references(ref_cells):
    from repro_torch.paper import run_all_cells as P

    assert P.ARCHS == ref_cells.ARCHS and P.SHAPES == ref_cells.SHAPES
    assert P.MB == ref_cells.MB == {"mixtral-8x22b": 8,
                                    "qwen3-moe-235b-a22b": 8}
    cmd = P.cell_command("qwen3-moe-235b-a22b", "train_4k", "o.json",
                         P.main.__globals__["argparse"].Namespace(
                             multipod=True, skip_cost=False,
                             serve_rules=False))
    assert cmd[1:] == ["-m", "repro_torch.launch.dryrun", "--arch",
                       "qwen3-moe-235b-a22b", "--shape", "train_4k",
                       "--microbatches", "8", "--out", "o.json",
                       "--multipod"]


def test_run_all_cells_resumes(tmp_path, monkeypatch, capsys):
    """The preflight on the CPU, then only the cells that are neither
    ``ok`` nor ``skipped`` in the output file run (an ``error`` row is
    run again and replaced); the file is rewritten after each cell."""
    from repro_torch.paper import run_all_cells as P

    done = [{"arch": a, "shape": s, "status": "ok"}
            for a in P.ARCHS for s in P.SHAPES]
    done[3] = {**done[3], "status": "error", "error": "boom"}
    done[5] = {**done[5], "status": "skipped", "reason": "r"}
    del done[7]
    out = tmp_path / "cells.json"
    out.write_text(json.dumps(done))
    ran = []

    def fake_cell(arch, shape, args):
        ran.append((arch, shape, P.MB.get(arch, 4)))
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": "stand-in"}

    monkeypatch.setattr(P, "run_cell", fake_cell)
    assert P.main([str(out), "--device", "cpu"]) == 0
    a = P.ARCHS[0]
    assert ran == [(a, P.SHAPES[3], 8), (P.ARCHS[1], P.SHAPES[3], 8)]
    rows = json.loads(out.read_text())
    assert len(rows) == len(P.ARCHS) * len(P.SHAPES)
    assert not any(r["status"] == "error" for r in rows)
    text = capsys.readouterr().out
    assert "[preflight] backend 'cuda' sweep parity vs oracle OK" in text
    assert f"TOTAL: {len(rows) - 3} ok, 3 skipped, 0 failed" in text
    monkeypatch.setattr(P, "pud_preflight", lambda *a: None)
    assert P.pending(rows) == []
    assert P.pending([], only_kinds="prefill") == [
        (arch, "prefill_32k") for arch in P.ARCHS]


def test_run_all_cells_preflight_refuses_a_bad_backend():
    from repro_torch.paper import run_all_cells as P

    with pytest.raises(ValueError, match=r"unknown backends \[.bogus.\]"):
        P.pud_preflight("bogus", "cpu")


def _dryrun_row(arch, shape, status="ok", total_gb=12.5, t_coll=2e-3):
    if status != "ok":
        return {"arch": arch, "shape": shape, "status": status,
                "reason": "the reason the shape does not apply"}
    return {"arch": arch, "shape": shape, "mesh": "16x16", "status": "ok",
            "memory": {"total_gb": total_gb},
            "roofline": {"t_compute_s": 1.5e-2, "t_memory_s": 0.25,
                         "t_collective_s": t_coll, "bottleneck": "memory",
                         "roofline_fraction": 0.0625,
                         "model_flops": 3.2e15, "hlo_efficiency": 0.5,
                         "mem_per_chip_gb": total_gb}}


def test_make_tables_writes_the_ports_file(tmp_path):
    """A two-cell dry-run file (and its serve-rules twin) into the four
    tables, in a file of the port's name; nothing else is written."""
    from repro_torch.paper import make_tables as T

    res = tmp_path / "results"
    res.mkdir()
    (res / "torch_dryrun_single.json").write_text(json.dumps(
        [_dryrun_row("chatglm3-6b", "decode_32k"),
         _dryrun_row("gemma-7b", "long_500k", "skipped")]))
    (res / "torch_dryrun_serve.json").write_text(json.dumps(
        [_dryrun_row("chatglm3-6b", "decode_32k", t_coll=5e-4)]))
    out = tmp_path / "torch_tables.md"
    with contextlib.redirect_stdout(io.StringIO()):
        assert T.main([str(out), "--results", str(res), "--root",
                       str(tmp_path / "sweeps")]) == 0
    text = out.read_text()
    assert sorted(os.listdir(tmp_path)) == ["results", "torch_tables.md"]
    assert "| chatglm3-6b | decode_32k | 12.5 GB | — | counted |" in text
    assert ("| gemma-7b | long_500k | — | — | skipped: the reason the "
            "shape does not apply |") in text
    assert ("| chatglm3-6b | decode_32k | 0.015 | 0.250 | 0.002 | memory |"
            " 0.062 | 3.20e+15 | 0.50 |") in text
    assert "| chatglm3-6b | decode_32k | 0.002 s | 5.00e-04 s | 4.0x |" in text
    assert f"(no sweep records under {tmp_path / 'sweeps'})" in text


#: The smoke chatglm3-6b train cell of ``tests/test_torch_dryrun.py`` on
#: a fake world of 8, its top collectives.
HILLCLIMB_CELL = r"""
import dataclasses, json
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch import dryrun as D, roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.paper.hillclimb import top_collectives
D.fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"), device="fake")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
c = D.count_cell(get_config("chatglm3-6b", smoke=True), shape, mesh)
top = top_collectives(c.collectives, n=1000)
print(json.dumps({"top": top[:8], "all": top,
                  "total": rl.collective_bytes(c.collectives).total_bytes,
                  "n": len(c.collectives)}))
"""


def test_hillclimb_top_collectives_on_the_smoke_cell():
    """Grouped by kind, issuing op and source, largest first; the groups
    cover every record; each names an aten op or a DTensor call and a
    module of the port."""
    proc = subprocess.run([sys.executable, "-c", HILLCLIMB_CELL], env=ENV,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    top, groups = got["top"], got["all"]
    assert len(top) == 8
    assert [g[0] for g in top] == sorted((g[0] for g in groups),
                                         reverse=True)[:8]
    assert sum(g[0] for g in groups) == got["total"]
    assert sum(g[4] for g in groups) == got["n"]
    for b, kind, op, source, count in groups:
        assert kind in ("all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all")
        assert op.startswith("aten.") or op in (
            "redistribute", "redistribute.backward", "distribute_tensor",
            "full_tensor"), op
        assert re.match(r"[a-z_]+/[a-z_0-9]+\.py:\w+", source), source


def test_hillclimb_cli_prints_the_cell(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper.hillclimb", "--arch",
         "xlstm-125m", "--shape", "decode_32k", "--show-collectives"],
        env=ENV, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == ("cell=xlstm-125m/decode_32k mb=1 serve_rules=False "
                        "overrides=[]")
    assert lines[2].startswith("flops/chip=")
    assert lines[3].startswith("collectives: total=")
    assert len(lines) == 4 + 8
    assert os.listdir(tmp_path) == []
