"""``grouped_ffn``'s Hopper kernel (``csrc/moe_ffn.cu``), the parts the CPU
can reach: numpy models of its walk and its layouts.  The walk: groups
sorted by expert into runs, the tiles of a run (m, n, member) with the
member fastest, the expert each group's weight coordinate names, which
tiles load and multiply, which GEMM 2 fills with zeros, which consumer
warpgroups multiply.  The layouts: the TMA boxes of the activations
(K-major, 128 rows) and of the weights (N-major 64 x 64 boxes), the swiglu
stage [wi | wu] and where h and u land in the m64n256 accumulator, the
epilogue's swizzled staging tile and its TMA store boxes.  Both passes are
multiplied out stage by stage and held against ``np.matmul`` with gelu and
swiglu.  The models read the tile constants (BM, BN, kStages, kBox,
kMaxGroups, kSmemMax; kRingK from ``csrc/hopper.cuh``) from the sources,
so a change to the kernel's tiling runs through them; the kernel itself
runs only on the card (``chip_smoke.py`` phase 1).

Tolerances: the models move float64 values without rounding them to bf16
and sum in another order than ``np.matmul`` (rtol 1e-9, atol 1e-9).
"""
import re
from pathlib import Path

import numpy as np
import pytest
from _tma_model import read_kmajor, read_mnmajor, tma_box, tma_store_box

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SOURCE = (CSRC / "moe_ffn.cu").read_text()
HOPPER = (CSRC / "hopper.cuh").read_text()


def constant(name: str, text: str = SOURCE) -> int:
    """The integer literal a ``constexpr int`` of the source is set to."""
    found = re.findall(rf"constexpr\s+int\s+(?:\w+\s*=\s*[^,;]+,\s*)*"
                       rf"{name}\s*=\s*(\d+)", text)
    assert len(found) == 1, f"{name} set {len(found)}x"
    return int(found[0])


BM, BN = constant("BM"), constant("BN")
BK = constant("kRingK", HOPPER)
STAGES = constant("kStages")
BOX = constant("kBox")
MAX_GROUPS = constant("kMaxGroups")
SMEM_MAX = constant("kSmemMax")
A_BYTES, B_BYTES = BM * BK * 2, BN * BK * 2        # a ring stage: 16 + 32 KB


def test_shared_memory_plan_fits():
    """The ring, two 64 x BN bf16 staging tiles, five walk tables and the
    barriers, behind a 1024-byte alignment, fit a block."""
    assert (BM, BN, BK) == (128, 256, 64)
    c_bytes = 2 * 64 * BN * 2
    total = STAGES * (A_BYTES + B_BYTES) + c_bytes + 5 * MAX_GROUPS * 4 \
        + 2 * STAGES * 8 + 1024
    assert total <= SMEM_MAX
    # the sort's keys borrow the staging tiles
    assert MAX_GROUPS * 4 <= c_bytes


# ---------------------------------------------------------------------------
# the walk (build_walk, tile_at, rows_of)
# ---------------------------------------------------------------------------

def rows_of(g, t, group_expert, group_rows):
    r = t if group_rows is None else min(max(int(group_rows[g]), 0), t)
    if group_expert is not None and group_expert[g] < 0:
        r = 0
    return r


def build_walk(groups, t, group_expert, group_rows):
    """The five tables of build_walk: position j -> (group, expert, rows,
    first position of its run, run length), by the kernel's rank count."""
    key = list(group_expert) if group_expert is not None else list(range(
        groups))
    tab = [None] * groups
    for g in range(groups):
        lt = sum(k < key[g] for k in key)
        eq = sum(k == key[g] for k in key)
        before = sum(key[j] == key[g] and j < g for j in range(groups))
        tab[lt + before] = (g, key[g], rows_of(g, t, group_expert,
                                               group_rows), lt, eq)
    return tab


def tile_at(t, groups, tiles_m, tiles_n, nc, tab, tt, group_expert,
            group_rows):
    """(g, e, rows, m0, n0) of tile t (csrc tile_at)."""
    tpg = tiles_m * tiles_n
    jl = t // tpg
    small = groups <= MAX_GROUPS
    j0, ln = (tab[jl][3], tab[jl][4]) if small else (jl, 1)
    u = t - j0 * tpg
    j = j0 + u % ln
    rest = u // ln
    n0, m0 = (rest % tiles_n) * nc, (rest // tiles_n) * BM
    if small:
        g, e, rows = tab[j][:3]
    else:
        g = j
        e = group_expert[j] if group_expert is not None else j
        rows = rows_of(j, tt, group_expert, group_rows)
    return g, e, rows, m0, n0


def walk(groups, t, n, nc, group_expert=None, group_rows=None):
    tiles_m, tiles_n = -(-t // BM), -(-n // nc)
    tab = build_walk(groups, t, group_expert, group_rows) \
        if groups <= MAX_GROUPS else None
    return [tile_at(i, groups, tiles_m, tiles_n, nc, tab, t, group_expert,
                    group_rows)
            for i in range(groups * tiles_m * tiles_n)]


# gpt2-moe serve decode / prefill (64 slots, 16 experts), Mixtral's (32
# slots, 8 experts), training (16 groups, no index), llama4's defaults (512
# slots of 128 experts), and past kMaxGroups (index order)
WALKS = [(64, 8, 3072, 16), (64, 24, 768, 16), (32, 640, 16384, 8),
         (16, 1288, 3072, 0), (512, 8, 512, 128), (MAX_GROUPS + 3, 9, 256, 40)]


@pytest.mark.parametrize("groups,t,n,n_exp", WALKS)
@pytest.mark.parametrize("nc", [BN, BN // 2])
def test_walk_covers_every_tile_once_in_runs(groups, t, n, n_exp, nc):
    """Every (group, m0, n0) once; the expert coordinate is the group's
    index entry; the groups of one expert form one run, whose tiles of one
    (m0, n0) are consecutive in the walk; without an index the walk is
    grouped_matmul's (n fastest, then m, then g)."""
    rng = np.random.RandomState(groups + t)
    ge = None
    if n_exp:
        ge = rng.randint(-1, n_exp, groups).astype(np.int32)
    tiles = walk(groups, t, n, nc, ge)
    seen = {(g, m0, n0) for g, _, _, m0, n0 in tiles}
    tiles_m, tiles_n = -(-t // BM), -(-n // nc)
    assert len(tiles) == len(seen) == groups * tiles_m * tiles_n
    for g, e, _, _, _ in tiles:
        assert e == (ge[g] if ge is not None else g)
    if ge is None:
        tpg = tiles_m * tiles_n
        for i, (g, _, _, m0, n0) in enumerate(tiles):
            assert (g, m0 // BM, n0 // nc) == (
                i // tpg, i % tpg // tiles_n, i % tiles_n)
        return
    if groups > MAX_GROUPS:      # index order, runs of one
        assert [tl[0] for tl in tiles[::tiles_m * tiles_n]] == \
            list(range(groups))
        return
    # experts in ascending order, each in one stretch of the walk
    experts = [e for _, e, _, _, _ in tiles]
    assert experts == sorted(experts)
    # inside a run, the members of one (m0, n0) are consecutive
    for e in set(experts):
        members = int((ge == e).sum())
        run = [tl for tl in tiles if tl[1] == e]
        for s in range(0, len(run), members):
            chunk = run[s:s + members]
            assert len({(m0, n0) for _, _, _, m0, n0 in chunk}) == 1
            assert sorted(g for g, *_ in chunk) == \
                sorted(np.flatnonzero(ge == e).tolist())


def test_walk_loads_multiplies_and_zeroes():
    """Which tiles load and multiply, which GEMM 2 fills with zeros, which
    warpgroups multiply, on a small case: 5 slots over 3 experts, T 300
    (three 128-row tiles), counts 300 / 0 / 129 / 64 / 200 with slot 4
    empty (-1)."""
    ge = np.array([2, 0, 2, 1, -1], np.int32)
    gr = np.array([300, 0, 129, 64, 200], np.int32)
    tiles = walk(5, 300, 256, BN, ge, gr)
    # sorted by expert: the empty slot 4 (-1), then 1 (expert 0), 3 (1),
    # and the run {0, 2} of expert 2, members fastest
    assert [tl[0] for tl in tiles] == [4, 4, 4, 1, 1, 1, 3, 3, 3,
                                       0, 2, 0, 2, 0, 2]
    assert [tl[1] for tl in tiles] == [-1] * 3 + [0] * 3 + [1] * 3 + [2] * 6
    loaded = {(g, m0): [m0 + 64 * wg < rows for wg in (0, 1)]
              for g, _, rows, m0, _ in tiles if m0 < rows}
    assert loaded == {(0, 0): [True, True], (0, 128): [True, True],
                      (0, 256): [True, False],       # 44 rows: one half
                      (2, 0): [True, True], (2, 128): [True, False],
                      (3, 0): [True, False]}
    zeroed = sorted((g, m0) for g, _, rows, m0, _ in tiles if m0 >= rows)
    assert zeroed == [(1, 0), (1, 128), (1, 256), (2, 256), (3, 128),
                      (3, 256), (4, 0), (4, 128), (4, 256)]


# ---------------------------------------------------------------------------
# the stage, the accumulator fragment, the epilogue
# ---------------------------------------------------------------------------

def fragment():
    """(thread, register) -> (row, column) of a warpgroup's m64n256
    accumulator: register i of thread (warp w, lane l) holds row 16 w +
    l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2."""
    th, i = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    w, lane = th >> 5, th & 31
    row = 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
    return row, col


def test_swiglu_registers_pair_h_with_u():
    """The accumulator covers the 64 x 256 tile once, and registers i and
    i + 64 of a thread hold one row at columns c and c + 128: h and u of
    the same column of F when the stage is [wi | wu]."""
    row, col = fragment()
    seen = np.zeros((64, BN), np.int64)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()
    assert (row[:, 64:] == row[:, :64]).all()
    assert (col[:, 64:] == col[:, :64] + BN // 2).all()
    assert (col[:, :64] < BN // 2).all()


def stage(a2, b_maps, m0, n0, k0, swiglu):
    """One ring stage as the producer loads it: a [T, K] K-major rows m0 ..
    m0 + 127 of k0 .. k0 + 63, then four 64 (n) x 64 (k) boxes of the
    N-major [K, N] weights; swiglu: wi columns n0 .. n0 + 127, then wu's."""
    smem = np.full((A_BYTES + B_BYTES) // 2, np.inf)   # (h may hold NaN)
    tma_box(smem, 2, 0, a2, k0, m0, BK, BM, True)
    for j in range(4):
        up = swiglu and j >= 2
        col = n0 + BOX * ((j & 1) if swiglu else j)
        tma_box(smem, 2, A_BYTES + j * (B_BYTES // 4), b_maps[int(up)], col,
                k0, BOX, BK, True)
    assert not np.isinf(smem).any()          # the boxes fill the stage
    return smem


def test_swiglu_stage_holds_wi_then_wu():
    """What the N-major descriptor reads from a swiglu stage: b columns 0 ..
    127 are wi's n0 .. n0 + 127, columns 128 .. 255 wu's, zero past F."""
    rng = np.random.RandomState(0)
    k, f = 64, 192
    wi, wu = rng.randn(k, f), rng.randn(k, f)
    a = rng.randn(10, k)
    for n0 in (0, 128):
        smem = stage(a, (wi, wu), 0, n0, 0, True)
        b = np.concatenate([read_mnmajor(smem, 2, A_BYTES + kk * 2048, BN, 16,
                                         B_BYTES // 4)
                            for kk in range(BK // 16)], axis=1)    # [n, k]
        want = np.zeros((BN, k))
        cols = np.arange(n0, min(n0 + 128, f))
        want[:len(cols)] = wi[:, cols].T
        want[128:128 + len(cols)] = wu[:, cols].T
        np.testing.assert_array_equal(b, want)


def gelu_kernel(v):
    """The kernel's gelu: v sigmoid(2 sqrt(2/pi) (v + 0.044715 v^3))."""
    return v / (1 + np.exp(-2 * 0.7978845608028654 * (v + 0.044715 * v ** 3)))


def silu(v):
    return v / (1 + np.exp(-v))


def test_gelu_form_is_the_tanh_form():
    v = np.linspace(-12, 12, 2001)
    tanh_form = 0.5 * v * (1 + np.tanh(0.7978845608028654
                                       * (v + 0.044715 * v ** 3)))
    np.testing.assert_allclose(gelu_kernel(v), tanh_form, rtol=1e-12,
                               atol=1e-12)


def run_pass(a, b_maps, epi, ge, gr, out=None):
    """One launch of ffn_gemm_kernel, tile by tile: a [G, T, K]; b_maps the
    [E, K, N] weights (wi, and wu for swiglu); epi "gelu" / "swiglu" (GEMM
    1, c = act(a @ b)) or "out" (GEMM 2, rows past the count zeroed).
    Returns c [G, T, N], NaN where the pass wrote nothing."""
    groups, t, k = a.shape
    n = b_maps[0].shape[2]
    swiglu = epi == "swiglu"
    nc = BN // 2 if swiglu else BN
    c = np.full((groups, t, n), np.nan) if out is None else out
    row, col = fragment()
    for g, e, rows, m0, n0 in walk(groups, t, n, nc, ge, gr):
        if m0 >= rows:
            if epi == "out":                 # zero_tile
                c[g, m0:m0 + BM, n0:n0 + BN] = 0.0
            continue
        acc = np.zeros((2, 64, BN))
        for k0 in range(0, k, BK):
            smem = stage(a[g], [bm[e] for bm in b_maps], m0, n0, k0, swiglu)
            for wg in range(2):
                if m0 + 64 * wg >= rows:     # its rows all past the count
                    continue
                for kk in range(BK // 16):
                    fa = read_kmajor(smem, 2, wg * (A_BYTES // 2) + kk * 32,
                                     64, 16)
                    fb = read_mnmajor(smem, 2, A_BYTES + kk * 2048, BN, 16,
                                      B_BYTES // 4)
                    acc[wg] += fa @ fb.T
        for wg in range(2):
            r0 = m0 + 64 * wg
            if r0 >= t or (epi != "out" and r0 >= rows):
                continue
            d = acc[wg][row, col]                   # [thread, register]
            if swiglu:
                vals, rr, cc = silu(d[:, :64]) * d[:, 64:], row[:, :64], \
                    col[:, :64]
            elif epi == "gelu":
                vals, rr, cc = gelu_kernel(d), row, col
            else:
                vals, rr, cc = np.where(row >= rows - r0, 0.0, d), row, col
            # put_pair: 64-column boxes of 64 rows x 128 bytes, swizzled
            staging = np.full(64 * BN, np.nan)
            off = rr * 128 + (cc % BOX) * 2
            swz = off ^ (((off >> 7) & 7) << 4)
            staging[((cc // BOX) * 64 * 128 + swz) // 2] = vals
            for cb in range(nc // BOX):
                if n0 + BOX * cb < n:
                    tma_store_box(c[g], staging, 2, cb * 64 * 128,
                                  n0 + BOX * cb, r0, BOX, 64)
    return c


def reference(x, wi, wu, wo, ge, gr, ffn):
    """np.matmul: out[g, r] = FFN_e(x[g, r]) for r < rows, else 0."""
    out = np.zeros_like(x)
    for g in range(x.shape[0]):
        e = ge[g] if ge is not None else g
        rows = rows_of(g, x.shape[1], ge, gr)
        h = x[g] @ wi[e]
        h = silu(h) * (x[g] @ wu[e]) if ffn == "swiglu" else gelu_kernel(h)
        out[g, :rows] = (h @ wo[e])[:rows]
    return out


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
@pytest.mark.parametrize("indexed", [False, True])
def test_kernel_model_multiplies(ffn, indexed):
    """Both passes, stage by stage, against np.matmul: ragged T (two row
    tiles, the second partial), F 320 (a partial column tile), with an
    index: 5 slots over 3 experts, one empty (-1), one with 0 rows, a
    count that ends mid-tile and one that ends inside the first
    warpgroup's rows."""
    rng = np.random.RandomState(3 + indexed)
    g, t, d, f = 5, 150, 128, 320
    e = 3 if indexed else g
    x = rng.randn(g, t, d) * 0.5
    gr = np.array([150, 0, 137, 40, 90], np.int32)
    ge = np.array([2, 0, 2, -1, 1], np.int32) if indexed else None
    x[np.arange(t)[None, :] >= gr[:, None]] = 0.0   # the callers' buffers
    wi = rng.randn(e, d, f) / np.sqrt(d)
    wu = rng.randn(e, d, f) / np.sqrt(d)
    wo = rng.randn(e, f, d) / np.sqrt(f)
    maps = (wi, wu) if ffn == "swiglu" else (wi,)
    h = run_pass(x, maps, ffn, ge, gr)
    out = run_pass(h, (wo,), "out", ge, gr)
    assert not np.isnan(out).any()                  # every row written
    np.testing.assert_allclose(out, reference(x, wi, wu, wo, ge, gr, ffn),
                               rtol=1e-9, atol=1e-9)
    # GEMM 1 wrote h only where GEMM 2 reads it: the counted row tiles
    for gg in range(g):
        rows = rows_of(gg, t, ge, gr)
        written = ~np.isnan(h[gg]).any(axis=1)
        halves = -(-rows // 64) * 64
        assert written[:halves].all() and not written[halves:].any()
