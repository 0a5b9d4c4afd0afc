"""The import guard: nothing under bench/ imports jax, jaxlib, flax or
the JAX package ``repro`` (top-level names compared whole, so
``repro_torch`` is not ``repro``); nothing under bench/reference/
imports repro_torch; and a run refuses to report with any of them
loaded."""
import ast
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not set(_top_level_imports(path)) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "repro_torch" not in set(_top_level_imports(path))


def test_run_refuses_with_a_forbidden_module_loaded(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert set(harness.forbidden_modules()) == before | {"repro"}
