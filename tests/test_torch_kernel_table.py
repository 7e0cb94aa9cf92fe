"""The table of TPU kernels and their Hopper counterparts cannot drift:
every ``pl.pallas_call`` site under ``src/repro/kernels/`` (found by parsing
the files with ``ast``, without importing them) has an entry in
``chip_smoke.py``'s ``REPLACES`` at its exact ``file:line``, every entry
names a real site, every ``SOURCE`` file exists and is built, every
kernel of the table has a launch counter, every ``BACKWARD`` kernel (the
backward of a forward kernel; it replaces no TPU kernel) names a kernel of
``REPLACES``, has a built ``SOURCE`` and a launch counter, and a shared
header's edit changes every library's build key."""
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
    assert source.keys() == (smoke_table("REPLACES").keys()
                             | smoke_table("BACKWARD").keys())
    for name, path in source.items():
        f = ROOT / path
        assert f.is_file(), (name, path)
        assert f.parent == _build.CSRC and f.stem in _build.SOURCES, path


def test_every_kernel_of_the_table_has_a_launch_counter():
    from repro_torch.kernels import COUNTERS
    assert sorted(COUNTERS) == sorted([*smoke_table("REPLACES"),
                                       *smoke_table("BACKWARD")])


def test_every_cuda_kernel_has_its_launch_witness():
    """``KERNEL_OWNERS`` names every ``__global__`` kernel of the sources,
    each owned by wrappers with a launch counter whose source defines it
    (the yardsticks' kernels by none)."""
    import re
    from repro_torch.kernels import COUNTERS, _build
    owners = smoke_table("KERNEL_OWNERS")
    source = smoke_table("SOURCE")
    defined = {}
    for f in sorted(_build.CSRC.glob("*.cu*")):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                               r"\([^)]*\)\s*)?(\w+)\s*\(", f.read_text()):
            defined.setdefault(name, set()).add(f.name)
    assert owners.keys() == defined.keys()
    for kernel, wrappers in owners.items():
        assert set(wrappers) <= COUNTERS.keys(), kernel
        for w in wrappers:
            cu = Path(source[w]).name
            assert cu in defined[kernel] or any(
                f'#include "{h}"' in (_build.CSRC / cu).read_text()
                for h in defined[kernel]), (kernel, w)


def test_every_backward_kernel_names_a_replacing_kernel():
    """Each BACKWARD entry is the backward of a kernel of REPLACES, is not
    itself in REPLACES, has a SOURCE of its own that is built and a launch
    counter."""
    from repro_torch.kernels import COUNTERS, _build
    backward = smoke_table("BACKWARD")
    replaces, source = smoke_table("REPLACES"), smoke_table("SOURCE")
    assert backward == {"rwkv6_wkv_bwd": "rwkv6_wkv",
                        "ssd_scan_bwd": "ssd_scan"}
    for name, of in backward.items():
        assert of in replaces and name not in replaces, name
        f = ROOT / source[name]
        assert f.is_file() and f.parent == _build.CSRC, source[name]
        assert f.stem in _build.SOURCES and f.stem in _build.SIGNATURES
        assert source[name] != source[of]
        assert name in COUNTERS and COUNTERS[name].name == name


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


def c_entry_points(source: str) -> dict:
    """``extern "C" int name(...)`` of a CUDA source -> the ctypes kinds of
    its parameters: "P" a pointer, "I" an int, "L" a long long."""
    import re
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source):
        kinds = []
        for param in m.group(2).split(","):
            decl = " ".join(param.split())
            kinds.append("P" if "*" in decl else
                         "L" if decl.startswith("long long") else
                         "I" if decl.startswith("int ") else decl)
        out[m.group(1)] = kinds
    return out


def test_every_signature_matches_its_c_entry_point():
    """ctypes passes each argument as ``_build.SIGNATURES`` declares it: a
    pointer as c_void_p, a size as c_int, a stride as c_longlong; a
    mismatch with the C declaration would cut a pointer or shift every
    later argument.  Each source's entry points and their kinds match."""
    import ctypes
    from repro_torch.kernels import _build
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_longlong: "L"}
    for name in _build.SOURCES:
        got = c_entry_points((_build.CSRC / f"{name}.cu").read_text())
        want = {fn: [kind[a] for a in args]
                for fn, args in _build.SIGNATURES[name].items()}
        assert got == want, name
