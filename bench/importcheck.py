"""The import rules of the benchmark, read from the sources.

Every module under ``bench/`` is parsed and the top-level name of each
module it imports (the part before the first dot) is compared whole:

  * ``jax``, ``jaxlib``, ``flax`` and ``repro`` (the JAX package) are
    refused everywhere; the port's name, ``repro_torch``, begins with
    ``repro`` but is another name;
  * ``repro_torch`` (the program) is refused in the yardstick's own
    modules: the reference, the work counts, the frozen inputs, the
    metric readers.

``run.py`` also looks in ``sys.modules`` once the window has closed, which
catches what the program loads in the process.
"""
from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent
EVERYWHERE = frozenset({"jax", "jaxlib", "flax", "repro"})
YARDSTICK = ("reference.py", "workcount.py", "frozen.py", "readers.py",
             "importcheck.py", "metrics/")
PROGRAM = "repro_torch"


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of the modules ``path`` imports (relative imports
    excepted)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def violations(root: Path = BENCH) -> list[str]:
    """Every import that breaks a rule, as ``file: name``."""
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        names = top_level_imports(path)
        bad = names & EVERYWHERE
        if rel.startswith(YARDSTICK) and PROGRAM in names:
            bad.add(PROGRAM)
        out += [f"{rel}: {n}" for n in sorted(bad)]
    return out
