"""The port's static contract checker (``python -m repro_torch.analysis``):
pass 1's inventory and registry of the twelve Hopper kernels, pass 2's
process-group lints, pass 3's first-time-cost detector and the CLI's exit
codes, each on the tree and on planted faults in temporary copies."""
from __future__ import annotations

import shutil
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (BASELINE, REGISTRY, RetraceError,
                                  analyze_collectives, analyze_kernels,
                                  iter_c_entries, iter_launch_sites,
                                  load_baseline, no_retrace, run_all)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.kernels import QUERIES, YARDSTICKS
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
KERNELS = PORT / "kernels"
# chip_smoke.py's kernels line: REPLACES, then BACKWARD
TWELVE = {"topk_gating_fused", "topk_positions", "dispatch_rows",
          "combine_rows", "weighted_route", "grouped_ffn", "grouped_matmul",
          "flash_attention", "rwkv6_wkv", "ssd_scan", "rwkv6_wkv_bwd",
          "ssd_scan_bwd"}


@pytest.fixture(scope="module")
def tree_findings():
    return run_all(str(ROOT))


def _copy_port(tmp_path) -> Path:
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "build"))
    return tmp_path


def test_pass1_finds_the_twelve_launch_sites_and_the_two_yardsticks():
    assert set(REGISTRY) == TWELVE
    sites = iter_launch_sites(str(KERNELS))
    got = {(Path(s.module).name, s.qualname, s.source, s.entry)
           for s in sites}
    want = {(e.module, e.qualname, e.source, e.entry)
            for e in REGISTRY.values()}
    assert want <= got
    rest = {(s.source, s.entry) for s in sites} - \
        {(e.source, e.entry) for e in REGISTRY.values()}
    assert rest == {("launch_floor", "launch_floor"),
                    ("topk_gating", "topk_positions_plan")}
    entries = {(src, ent) for src, ent, _ in iter_c_entries(
        str(KERNELS / "csrc"))}
    assert entries == {(e.source, e.entry) for e in REGISTRY.values()} | \
        {(s, e) for e, s in {**YARDSTICKS, **QUERIES}.items()}
    assert set(YARDSTICKS) == {"launch_floor", "mma_forms"}


def test_pass1_on_the_tree_is_the_committed_baseline(tree_findings):
    assert {f.fingerprint for f in tree_findings} == \
        load_baseline(str(ROOT / BASELINE))
    assert not [f for f in tree_findings if f.category == "refused-shape"]


def test_pass1_flags_a_planted_site_and_a_stale_entry(tmp_path):
    root = _copy_port(tmp_path)
    kdir = root / "src" / "repro_torch" / "kernels"
    (kdir / "planted.py").write_text(textwrap.dedent('''
        from repro_torch.kernels._build import lib

        def planted_rows(x):
            return lib("dispatch").planted_rows(x)
        '''))
    (kdir / "csrc" / "planted.cu").write_text(
        'extern "C" int planted_entry(void* stream) { return 0; }\n')
    disp = kdir / "dispatch.py"
    disp.write_text(disp.read_text().replace("def combine_rows(",
                                             "def combine_rows_v2("))
    found = {f.fingerprint for f in analyze_kernels(str(kdir), cases=[])}
    rel = "src/repro_torch/kernels"
    assert found == {
        f"unregistered-kernel:{rel}/planted.py:planted_rows:"
        f"dispatch.planted_rows",
        f"unregistered-kernel:{rel}/dispatch.py:combine_rows_v2:"
        f"dispatch.combine_rows",
        f"unregistered-kernel:{rel}/csrc/planted.cu:planted_entry:"
        f"planted.planted_entry",
        f"site-mismatch:{rel}/dispatch.py:combine_rows:site"}


def test_pass1_checks_shared_memory_grids_and_edges():
    import re
    from repro_torch.analysis.kernels import (Case, _f32, _m, check_case,
                                              check_edges, check_smem)
    from repro_torch.kernels import moe_ffn
    text = (KERNELS / "csrc" / "moe_ffn.cu").read_text()
    assert moe_ffn.MAX_GROUPS == int(re.search(
        r"constexpr int kMaxGroups = (\d+);", text).group(1)) == 512
    ffn = REGISTRY["grouped_ffn"]
    assert check_smem(ffn, text, "m") == []
    assert {f.key for f in check_smem(ffn, text.replace(
        "static_assert(kSmem <= kSmemMax,", "static_assert(true,"),
        "m")} == {"kSmem"}
    assert {f.key for f in check_smem(ffn, text.replace(
        "kSmemMax = 232448;", "kSmemMax = 232449;"), "m")} == {"kSmemMax"}
    big = Case("grouped_ffn", "513 groups", (
        _m(513, 64, 64), _m(8, 64, 128), None, _m(8, 128, 64), "gelu",
        _m(513, dtype=__import__("torch").int32), None))
    cats = {f.category: f.severity for f in check_case(ffn, big, "m")}
    assert cats == {"grid-over-limit": "warning"}
    wkv = REGISTRY["rwkv6_wkv_bwd"]
    wide = Case("rwkv6_wkv_bwd", "batch 70000", tuple(
        [_m(70000, 64, 1, 64)] * 3 + [_f32(70000, 64, 1, 64),
                                      _f32(1, 64), None,
                                      _f32(70000, 64, 1, 64), None]))
    assert [f.key for f in check_case(wkv, wide, "m")] == \
        ["grid:batch 70000"]
    for e in REGISTRY.values():
        assert check_edges(e, "m") == []
        assert any(ec.accepted for ec in e.edges)
        assert any(not ec.accepted for ec in e.edges)


PLANTED = {
    "axis-literal": 'AXIS = "model"\n',
    "unbound-axis": textwrap.dedent('''
        def f(mesh):
            return mesh.group("experts")
        '''),
    "raw-collective": textwrap.dedent('''
        import torch.distributed as dist

        def f(t):
            dist.all_reduce(t)
        '''),
    "dropped-ordering": textwrap.dedent('''
        from repro_torch.core.axes import MODEL
        from repro_torch.core.microop import _exchange

        def f(x, mesh):
            return _exchange(x, mesh, True)[0]

        def g(x, out, mesh):
            work = mesh.all_to_all(out, x, mesh.group(MODEL), async_op=True)
            return out

        def h(x, out, mesh, pending):
            mesh.all_to_all(out, x, mesh.group(MODEL), async_op=pending)
            return out
        '''),
}


def test_pass2_is_clean_on_the_tree():
    assert analyze_collectives(str(PORT)) == []


@pytest.mark.parametrize("category", sorted(PLANTED))
def test_pass2_flags_each_planted_fault(tmp_path, category):
    (tmp_path / "planted.py").write_text(PLANTED[category])
    found = analyze_collectives(str(tmp_path), rel_prefix="")
    assert {f.category for f in found} == {category}
    if category == "dropped-ordering":
        assert {f.qualname for f in found} == {"f", "g", "h"}


def test_pass2_takes_an_exchange_that_is_marked(tmp_path):
    (tmp_path / "ok.py").write_text(textwrap.dedent('''
        from repro_torch.core.axes import MODEL
        from repro_torch.core.microop import _exchange

        def f(x, mesh):
            out, _ = _exchange(x, mesh)
            mesh.mark("a2a")
            return out

        def g(x, out, mesh):
            work = mesh.all_to_all(out, x, mesh.group(MODEL),
                                   async_op=True)
            return out, work
        '''))
    assert analyze_collectives(str(tmp_path), rel_prefix="") == []


def test_pass2_takes_a_blocking_exchange_without_a_mark(tmp_path):
    (tmp_path / "ok.py").write_text(textwrap.dedent('''
        from repro_torch.core.axes import MODEL
        from repro_torch.core.microop import _exchange

        def f(x, mesh):
            return _exchange(x, mesh)[0]

        def g(x, out, mesh):
            mesh.all_to_all(out, x, mesh.group(MODEL))
            work = mesh.all_to_all(out, x, mesh.group(MODEL),
                                   async_op=False)
            return out
        '''))
    assert analyze_collectives(str(tmp_path), rel_prefix="") == []


def test_pass3_catches_a_window_that_loads_a_library(monkeypatch):
    class StandIn:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return type("Fn", (), {})()
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", lambda: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL", StandIn)
    with no_retrace("quiet") as rep:
        pass
    assert rep.count == 0 and rep.ok and rep.segments is None
    with pytest.raises(RetraceError, match="1 library load"):
        with no_retrace("load"):
            _build.lib("dispatch")
    with no_retrace("again"):             # loaded once: no second load
        _build.lib("dispatch")
    with no_retrace("lenient", strict=False) as rep:
        _build.lib("ssd")
    assert (rep.count, rep.loads, rep.ok) == (1, 1, False)


def test_cli_exit_codes(tmp_path, tree_findings, capsys):
    assert cli.main(["--root", str(ROOT), "--baseline",
                     str(ROOT / BASELINE), "--fail-on-new"]) == 0
    root = _copy_port(tmp_path)
    (root / "src" / "repro_torch" / "planted.py").write_text(
        PLANTED["raw-collective"])
    assert cli.main(["--root", str(root), "--baseline",
                     str(ROOT / BASELINE), "--fail-on-new"]) == 2
    assert "NEW" in capsys.readouterr().out
