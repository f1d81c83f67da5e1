"""Nothing under perfbench imports JAX or the JAX package, and the plain
references import nothing of the program, not even through the modules of
the benchmark they use. Top-level module names are compared whole:
``repro_torch`` starts with ``repro`` and is not it."""

import ast
from pathlib import Path

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    """(top-level name, full dotted name) of every import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.module
            for a in node.names:
                yield node.module.split(".")[0], f"{node.module}.{a.name}"


@pytest.mark.parametrize("path", FILES, ids=[p.relative_to(BENCH).as_posix() for p in FILES])
def test_no_jax_anywhere(path):
    assert not {top for top, _ in _imports(path)} & FORBIDDEN


def _closure(path: Path, seen=None):
    """The file and every benchmark module it imports, transitively."""
    seen = set() if seen is None else seen
    if path in seen:
        return seen
    seen.add(path)
    for top, full in _imports(path):
        if top != "yardstick":
            continue
        parts = full.split(".")
        for n in range(len(parts), 0, -1):
            cand = BENCH.joinpath(*parts[:n]).with_suffix(".py")
            if cand.exists():
                _closure(cand, seen)
                break
    return seen


REFS = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFS, ids=[p.name for p in REFS])
def test_references_import_nothing_of_the_program(path):
    files = _closure(path)
    assert BENCH / "yardstick" / "plain.py" in files
    for f in files:
        tops = {top for top, _ in _imports(f)}
        assert "repro_torch" not in tops, f
        assert tops <= {"__future__", "contextlib", "math", "typing", "dataclasses", "torch",
                        "numpy", "yardstick", "functools"}, (f, tops)


def test_the_check_is_caught_by_whole_names():
    from yardstick import runner

    assert runner.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    import sys

    sys.modules["repro_torch_like"] = sys.modules.get("repro_torch_like") or type(sys)("repro_torch_like")
    try:
        assert "repro" not in runner.forbidden_modules()
    finally:
        del sys.modules["repro_torch_like"]
