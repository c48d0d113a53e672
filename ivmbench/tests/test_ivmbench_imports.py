"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``materialize_tpu_torch`` begins with
``materialize_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from ivmbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "materialize_tpu"}


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imported(path) & FORBIDDEN


def test_top_level_names_compared_whole():
    assert "materialize_tpu_torch" not in FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert not _imported(path) & (FORBIDDEN | {"materialize_tpu_torch"})
    refs = ", ".join(f"ivmbench.reference.{p.stem}"
                     for p in sorted((HERE / "reference").glob("*.py")) if p.stem != "__init__")
    code = (f"import sys; import {refs}, "
            "ivmbench.check, ivmbench.gen.feed, ivmbench.gen.tpch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'materialize_tpu', 'materialize_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.forbidden_modules() == ["jaxlib.fake"]
    monkeypatch.delitem(sys.modules, "jaxlib.fake")
    monkeypatch.setitem(sys.modules, "materialize_tpu_torchy", object())
    assert run.forbidden_modules() == []
