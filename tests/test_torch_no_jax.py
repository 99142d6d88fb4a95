"""The PyTorch port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, directly or
transitively. Checked twice: by importing every module in a fresh
interpreter, and statically over the sources (which also catches imports
inside functions that an import alone would not run). Nor does any of
them import ``pickle``: saved models and checkpoints are plain data."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED_ROOTS = ("jax", "jaxlib", "repro")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = ['repro_torch'] + [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED_ROOTS!r} or m.startswith('jax'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every submodule was imported


def _imported_roots(tree: ast.AST) -> list[tuple[int, str]]:
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module or ""))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            found.append((node.lineno, node.args[0].value))
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line}: {name}" for line, name in _imported_roots(tree)
           if name.split(".")[0] in BANNED_ROOTS]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_pickle(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line}: {name}" for line, name in _imported_roots(tree)
           if name.split(".")[0] in ("pickle", "cPickle", "dill", "cloudpickle")]
    assert not bad, bad


def test_static_check_tells_repro_torch_from_repro():
    tree = ast.parse("import repro_torch.core\nfrom repro_torch import x\n"
                     "from repro.core import tree\nimport jax.numpy as jnp\n"
                     "importlib.import_module('repro.serving')\n")
    roots = [n.split(".")[0] for _, n in _imported_roots(tree)]
    assert [r for r in roots if r in BANNED_ROOTS] == ["repro", "jax", "repro"]
