"""The table of TPU kernels and their Hopper counterparts cannot drift:
every ``pl.pallas_call`` site under ``src/repro/kernels/`` (found by parsing
the files with ``ast``, without importing them) has an entry in
``chip_smoke.py``'s ``REPLACES`` at its exact ``file:line``, every entry
names a real site, every ``SOURCE`` file exists and is built, every
kernel of the table has a launch counter, and a shared header's edit
changes every library's build key."""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def pallas_sites() -> set:
    sites = set()
    for f in sorted((ROOT / "src" / "repro" / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "pallas_call":
                sites.add(f"{f.relative_to(ROOT).as_posix()}:{node.lineno}")
    return sites


def smoke_table(name: str) -> dict:
    """The dict literal assigned to ``name`` at the top of chip_smoke.py."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                [getattr(t, "id", None) for t in node.targets] == [name]:
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py assigns no {name}")


def test_every_pallas_call_site_has_exactly_one_replacement():
    sites = pallas_sites()
    replaces = smoke_table("REPLACES")
    assert len(sites) == 10
    assert sorted(replaces.values()) == sorted(sites)     # one entry a site


def test_every_source_exists_and_is_built():
    from repro_torch.kernels import _build
    source = smoke_table("SOURCE")
    assert source.keys() == smoke_table("REPLACES").keys()
    for name, path in source.items():
        f = ROOT / path
        assert f.is_file(), (name, path)
        assert f.parent == _build.CSRC and f.stem in _build.SOURCES, path


def test_every_kernel_of_the_table_has_a_launch_counter():
    from repro_torch.kernels import COUNTERS
    assert sorted(COUNTERS) == sorted(smoke_table("REPLACES"))


def test_a_header_edit_changes_every_build_key(tmp_path, monkeypatch):
    """Each library's build key hashes its source and every csrc/*.cuh, so
    an edit to a shared header rebuilds every library."""
    from repro_torch.kernels import _build
    for name in ("one", "two"):
        (tmp_path / f"{name}.cu").write_text(f'#include "h.cuh"  // {name}')
    (tmp_path / "h.cuh").write_text("// v1")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in ("one", "two")}
    assert before["one"] != before["two"]
    (tmp_path / "h.cuh").write_text("// v2")
    after = {n: _build._lib_path(n) for n in ("one", "two")}
    assert all(after[n] != before[n] for n in before)
    assert after == {n: _build._lib_path(n) for n in ("one", "two")}
