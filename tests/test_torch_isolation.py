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


def test_entry_points_default_to_the_card():
    assert ExecutionContext().device == "cuda"
