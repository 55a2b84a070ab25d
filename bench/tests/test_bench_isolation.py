"""What the harness may import and read: nothing of JAX or the JAX
package anywhere under bench/ (top-level names compared whole: the port's
name begins with the JAX package's), nothing of the program in the
references, metric readers and work counts, and nothing of the JAX
package's benchmarks folder."""

import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
JAX = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference", "metrics", "work")


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.relative_to(BENCH).parts[0] in YARDSTICK],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_benchmarks(path):
    assert "benchmarks" not in path.read_text()


def test_the_names_compare_whole():
    assert "repro_torch" not in JAX and "repro_torch".split(".")[0] != "repro"
