"""Nothing in bench/ imports JAX or the JAX package; the yardstick imports
nothing of the program; nothing reads benchmarks/."""
from bench import importcheck


def test_bench_sources_keep_the_rules():
    assert importcheck.violations() == []


def test_rules_compare_whole_top_level_names(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "generators").mkdir()
    (tmp_path / "reference.py").write_text("import repro_torch.core\n")
    (tmp_path / "metrics" / "m.py").write_text("from repro.core import x\n")
    (tmp_path / "generators" / "d.py").write_text(
        "import repro_torch\nimport jax.numpy as jnp\nimport reprox\n")
    assert importcheck.violations(tmp_path) == [
        "generators/d.py: jax", "metrics/m.py: repro",
        "reference.py: repro_torch"]


def test_nothing_reads_the_old_benchmarks_folder():
    for path in importcheck.BENCH.rglob("*.py"):
        if path.name != "test_bench_imports.py":
            assert "benchmarks/" not in path.read_text(), path
