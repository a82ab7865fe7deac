"""Whole runs on the CPU at small sizes (the look for a card skipped):
sound runs come out correct; a run with the timed path broken underneath
comes out not correct; so does the control; and nothing a run loads is
JAX or the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.tests._util import ROOT, SEED, SMALL, cells_of, \
    spec_and_shelved
from port_bench.harness import runner
from port_bench.harness.spec import load_spec
from port_bench.control.run_control import control_checks

ARITH = cells_of("arith")
SERVE = cells_of("serve")
FULL = spec_and_shelved()


def run(cell, monkeypatch=None, seconds=1.0, trace=False):
    return runner.run_cell(cell, SEED, seconds, trace, device="cpu",
                           overrides=SMALL, spec=FULL,
                           out=open(os.devnull, "w"))


@pytest.mark.parametrize("cell", ARITH + SERVE)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("cell", ARITH + SERVE)
def test_traced_run_reports_its_per_layer_metrics(cell):
    res = run(cell, trace=True)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in res["metrics"]


@pytest.mark.parametrize("cell", ARITH[:1] + SERVE)
def test_traced_run_reads_host_metrics_from_an_untraced_window(
        cell, monkeypatch):
    from port_bench.harness import spec as specs

    drv = specs.driver(specs.load_cell(cell, FULL).config)
    windows, traced = [], {}
    window, reader = drv.window, specs.metric_reader

    def spy_window(st, seconds, prof):
        windows.append(prof.enabled)
        return window(st, seconds, prof)

    def spy_reader(name):
        def read(rec):
            traced[name] = rec.trace is not None
            return reader(name).read(rec)
        return type("Reader", (), {"read": staticmethod(read)})

    monkeypatch.setattr(drv, "window", spy_window)
    monkeypatch.setattr(specs, "metric_reader", spy_reader)
    res = run(cell, trace=True)
    assert res["correct"] and windows == [False, True]
    for m in specs.load_cell(cell, FULL).per_layer:
        assert traced[m["name"]] == (m["source"] == "device_trace"), m


def _unchanged(self, program, state, **kw):
    return self.backend.words(state).clone()


def _altered_outputs(orig):
    def outputs(self, final):
        out = orig(self, final).clone()
        out[0] ^= 1
        return out
    return outputs


def _half_outputs(orig):
    def outputs(self, final):
        out = orig(self, final).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return outputs


@pytest.mark.parametrize("cell", ARITH)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_arith_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.compile.trace import CompiledProgram
    from repro_torch.session import DramSession

    if fault == "unchanged":
        monkeypatch.setattr(DramSession, "run_fused", _unchanged)
    else:
        wrap = _half_outputs if fault == "half" else _altered_outputs
        monkeypatch.setattr(CompiledProgram, "outputs",
                            wrap(CompiledProgram.outputs))
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_lanes"]["value"] > 0


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_serve_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.session import DramSession

    if fault == "unchanged":
        monkeypatch.setattr(DramSession, "run_fused", _unchanged)
    elif fault == "half":
        orig = DramSession.run_fused

        def half(self, program, state, **kw):
            final = orig(self, program, state, **kw)
            rows = final.shape[0]
            final[rows // 2:] = self.backend.words(state)[rows // 2:]
            return final
        monkeypatch.setattr(DramSession, "run_fused", half)
    else:
        orig = DramSession.mismatch
        monkeypatch.setattr(DramSession, "mismatch",
                            lambda self, a, b: orig(self, a, b) + 1)
    res = run(cell)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ARITH[:1] + SERVE)
def test_control_is_not_correct(cell):
    checks = control_checks(cell, SEED, "cpu", SMALL)
    assert not all(c["ok"] for c in checks.values())


PROBE = r"""
import json, os, sys
sys.path[:0] = [{src!r}, {root!r}]
from port_bench.harness import runner
from port_bench.tests._util import SEED, SMALL, spec_and_shelved
res = runner.run_cell({cell!r}, SEED, 2.0, {trace}, device="cpu",
                      overrides=SMALL, spec=spec_and_shelved(),
                      out=open(os.devnull, "w"))
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "tops": tops}}))
"""


@pytest.mark.parametrize("cell,trace", [(ARITH[0], True),
                                        (ARITH[-1], False),
                                        (SERVE[0], True)])
def test_run_loads_no_jax_and_no_reference_package(cell, trace):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), cell=cell,
                        trace=trace)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    bad = {"jax", "jaxlib", "flax", "repro"}.intersection(res["tops"])
    assert not bad
    assert "repro_torch" in res["tops"]


def test_references_import_only_numpy():
    import ast

    for path in sorted((ROOT / "port_bench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add((node.module or "").split(".")[0])
        assert tops <= {"__future__", "numpy"}, (path.name, tops)


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         ARITH[0], "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=300, cwd=cwd, env=env)


def test_cli_without_a_card_fails_and_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_cli_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load_spec()["workloads"]])
def test_short_run_on_the_card(cell, cuda_device):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
