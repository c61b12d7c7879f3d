"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program. Names are compared by
their top-level part, whole: the port's package name begins with the
JAX package's."""
from __future__ import annotations

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_benchmark_has_modules():
    assert len(MODULES) > 10


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert not found & (FORBIDDEN | PROGRAM)
    assert found <= {"__future__", "dataclasses", "torch"}


def test_the_guard_sees_each_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy\nfrom repro.core import x\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "import repro_torch\n")
    assert top_level_imports(f) == {"jax", "repro", "importlib", "flax",
                                    "repro_torch"}
