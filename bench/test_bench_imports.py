"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro``, compared by whole top-level names (the port's
``repro_torch`` begins with ``repro``); the reference imports nothing of
the port either.  The run's own check of ``sys.modules`` compares the
same way."""
import ast
import sys
from pathlib import Path

import pytest

from bench import harness as H

FILES = sorted(H.BENCH.rglob("*.py"))
REF = H.BENCH / "reference"


def _imports(path: Path) -> list:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append(str(node.args[0].value))
    return [n.split(".")[0] for n in out]


def test_the_walk_sees_the_harness():
    names = {p.relative_to(H.BENCH).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference/transformer.py",
            "drivers/train.py", "drivers/serve.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(H.BENCH).as_posix()
                              for p in FILES])
def test_no_jax_and_no_reference_package(path):
    bad = set(_imports(path)) & set(H.FORBIDDEN)
    if path.is_relative_to(REF):
        bad |= set(_imports(path)) & {"repro_torch"}
    assert not bad, f"{path.relative_to(H.BENCH)} imports {sorted(bad)}"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("repro", "repro.core", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    found = H.forbidden_modules()
    assert {"repro", "repro.core", "jax", "jaxlib.xla", "flax"} <= set(found)
    assert "repro_torch_lookalike" not in found
    assert not [m for m in found if m.startswith("repro_torch")]
