"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: dladmm_tpu_torch is not dladmm_tpu), and nothing
under benchmark/reference/ imports the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dladmm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "dladmm_tpu_torch" not in set(_imports(path))
    assert "dladmm_tpu_torch" not in path.read_text()


def test_the_harness_names_jax_modules_whole():
    import sys

    from benchmark.harness import jax_modules

    assert jax_modules() == []
    sys.modules["dladmm_tpu.fake"] = object()
    try:
        assert jax_modules() == ["dladmm_tpu"]
    finally:
        del sys.modules["dladmm_tpu.fake"]
