"""No module under bench/ imports JAX, flax, the JAX package or the JAX
benchmarks; the reference imports nothing of the port.  Top-level names
are compared whole (``repro_torch`` begins with ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_bench_module_imports_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_bench_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"repro_torch"})


def test_bench_whole_name_comparison():
    import harness
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.models",
                                     "jaxtyping", "numpy"]) == []
    assert harness.forbidden_loaded(["repro.core", "jax.numpy", "flax"]) \
        == ["flax", "jax", "repro"]
