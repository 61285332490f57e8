"""Nothing under fisrbench/ imports the JAX side (top-level module names
compared whole: fisr_tpu_torch is not fisr_tpu), and the reference imports
nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fisr_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]
    assert files
    for p in files:
        bad = set(_imports(p)) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_reference_imports_no_program():
    files = list((BENCH / "reference").rglob("*.py"))
    assert files
    for p in files:
        tops = set(_imports(p))
        assert not tops & (FORBIDDEN | {"fisr_tpu_torch"}), f"{p} imports {tops}"


def test_the_check_compares_whole_names():
    from fisrbench import run

    assert "fisr_tpu" in run.FORBIDDEN
    assert "fisr_tpu_torch".split(".")[0] not in run.FORBIDDEN
