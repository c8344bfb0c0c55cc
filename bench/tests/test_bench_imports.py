"""Nothing under bench/ imports JAX or the JAX package, and only the
system-under-test adapter imports the port.  Module names are compared
by their top-level name (the part before the first dot), whole: the
port's name begins with the JAX package's."""

import ast

import pytest

from harness.cell import FORBIDDEN
from harness.manifest import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


def test_only_the_adapter_and_the_tests_import_the_port():
    users = {p.relative_to(BENCH).as_posix() for p in SOURCES
             if "repro_torch" in top_level_imports(p)}
    assert {u for u in users if not u.startswith("tests/")} == {
        "harness/port.py"}


def test_reference_imports_nothing_of_the_port():
    imports = top_level_imports(BENCH / "harness" / "reference.py")
    assert "repro_torch" not in imports and "repro" not in imports
    assert imports <= {"__future__", "contextlib", "typing", "torch"}


def test_the_check_compares_whole_names():
    import sys

    from harness.cell import forbidden_modules

    sys.modules["repro_torchlike"] = sys
    try:
        assert "repro" not in forbidden_modules()
    finally:
        del sys.modules["repro_torchlike"]
