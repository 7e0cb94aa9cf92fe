"""The port stands alone: no module of ``src/repro_torch/`` (and not
``chip_smoke.py``) imports ``jax`` or anything of the reference package
``repro``; they keep their own copies of what they need."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(tree: ast.Module) -> list:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue           # relative: inside the port
            out.append((node.module or "", node.lineno))
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append((node.args[0].value, node.lineno))
    return out


def test_the_walk_sees_the_new_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("analysis/kernels.py", "analysis/collectives.py",
                "launch/dryrun.py", "launch/sweep.py", "launch/analytic.py",
                "launch/hlo_analysis.py", "data/pipeline.py"):
        assert f"src/repro_torch/{mod}" in names
    assert len(FILES) > 60


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_and_no_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
