"""The port stands alone: no JAX, nothing of the reference package.

``repro_torch`` runs on machines that have no JAX, so neither its source
nor its import graph may reach ``jax`` or ``repro``.  Only the tests
import both packages.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import repro_torch
from repro_torch.backends import ExecutionContext

PKG_DIR = os.path.dirname(repro_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], "repro_torch.")]


def _top(name: str) -> str:
    return name.split(".")[0]


def _forbidden_imports(path: str) -> list[tuple[str, str]]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        offenders += [(path, n) for n in names if _top(n) in FORBIDDEN]
    return offenders


def test_no_forbidden_import_in_source():
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for fname in files:
            if fname.endswith(".py"):
                offenders += _forbidden_imports(os.path.join(dirpath, fname))
    assert not offenders


def test_chip_smoke_imports_no_jax_and_no_reference():
    """``chip_smoke.py`` runs on the card's machine, which has no JAX."""
    path = os.path.join(os.path.dirname(os.path.dirname(PKG_DIR)),
                        "chip_smoke.py")
    assert os.path.exists(path)
    assert not _forbidden_imports(path)


def test_importing_every_module_loads_no_jax_and_no_reference():
    modules = _modules()
    assert len(modules) > 20
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    src = os.path.dirname(PKG_DIR)
    env = {**os.environ, "PYTHONPATH": src}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: Entry points that take ``--device``, each with the other arguments it
#: needs; run with no ``--device``, each must try the card.
DEVICE_ENTRY_POINTS = (
    ("repro_torch.paper.run", []),
    ("repro_torch.paper.run_all_cells", ["{tmp}/cells.json"]),
    ("repro_torch.examples.quickstart", []),
    ("repro_torch.examples.pud_arithmetic", []),
    ("repro_torch.examples.serve_batch", []),
    ("repro_torch.examples.tmr_checkpoint_demo", []),
    ("repro_torch.examples.train_tiny_lm", ["--small", "--steps", "2"]),
)


def test_entry_points_default_to_the_card(tmp_path):
    """The execution context defaults to the card, and so does each
    ``--device`` entry point of ``paper/`` and ``examples/`` (and of
    ``kernel_bench`` and ``figures``' functions): with no card, each
    raises on its first use of it rather than fall back to the CPU, and
    writes nothing."""
    import importlib
    import inspect

    import torch

    assert ExecutionContext().device == "cuda"
    from repro_torch.paper import figures, kernel_bench

    for fn in figures.FIGURES + (kernel_bench.kernel_benchmarks,):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__name__
    if torch.cuda.is_available():
        return
    for name, argv in DEVICE_ENTRY_POINTS:
        mod = importlib.import_module(name)
        args = [a.format(tmp=tmp_path) for a in argv]
        try:
            mod.main(args)
        except (AssertionError, RuntimeError) as e:
            assert "cuda" in str(e).lower(), (name, e)
        else:
            raise AssertionError(f"{name} ran without a card")
    assert os.listdir(tmp_path) == []
