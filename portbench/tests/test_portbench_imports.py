"""Nothing of the benchmark imports JAX, flax, the JAX package (``repro``,
compared as a whole top-level name: ``repro_torch`` is another) or the
port's oracles and test helpers, and the reference imports nothing of the
port at all; the harness refuses a run that has loaded any of them."""

import ast
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py"))
ORACLES = ("chip_smoke", "benchmarks", "tests", "conftest")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_forbidden_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in harness.FORBIDDEN_MODULES, (path, name)
        assert top not in ORACLES, (path, name)
        # the port's plain oracles of its kernels
        assert not (top == "repro_torch" and name.split(".")[-1] == "ref"), (path, name)
        if path.parent.name == "reference":
            assert top != "repro_torch", (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serve", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "repro.serve"]
