"""``flash_attention``'s Hopper kernel (``csrc/flash_attention.cu``), the
parts the CPU can reach: numpy models of its index arithmetic — the 4-D TMA
boxes over [B, S, heads, hd] (the GQA head, zero fill past S, the store's
clipping), the wgmma descriptors of Q and K (K-major) and of V (N-major,
the transpose bit) through the 128-byte swizzle, the m64n128 accumulator
read as the A fragments of P V, the epilogue's swizzled O writes, the
classification of KV tiles (skipped / unmasked / masked), the online
softmax with its -2^100 mask, the shared-memory plan and the persistent
walk — multiplied out and held against dense attention in numpy.  The
models read the tiling constants (BM, BN, kStages, kSmemMax, kMask) from
the source, so a change to the kernel's tiling runs through them; the
kernel itself runs only on the card (``chip_smoke.py`` phase 1).

Tolerances: the models move float32 values without rounding them to bf16
and sum in float32 or float64 (rtol 1e-4, atol 1e-5: another order).
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
from _tma_model import (a_frag_pos, acc_pos, read_kmajor, read_mnmajor,
                        sw128)

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()


def source_constant(name: str) -> str:
    """The literal a ``constexpr`` of flash_attention.cu is set to."""
    found = re.findall(rf"constexpr\s+\w+\s+{name}\s*=\s*([^;]+);", SOURCE)
    assert len(found) == 1, f"flash_attention.cu sets {name} {len(found)}x"
    return found[0].strip()


BM = int(source_constant("BM"))             # query rows an item
BN = int(source_constant("BN"))             # keys a KV tile
STAGES = int(source_constant("kStages"))    # the K / V ring
SMEM_MAX = int(source_constant("kSmemMax"))  # a block's dynamic smem
# a masked score before the scale (a C hex-float literal)
MASK = np.float32(float.fromhex(source_constant("kMask").rstrip("fF")))
SMS = 132                     # H100 SXM


def smem_plan(hd):
    """Smem<HD>: byte offsets of Q, the K / V stages, O and the barriers,
    and the bytes the launch asks for."""
    q, kv, o = BM * hd * 2, BN * hd * 2, BM * hd * 2
    st = STAGES
    plan = {"q": 0, "o": q + st * 2 * kv, "bar": q + st * 2 * kv + o}
    for s in range(st):
        plan[f"k{s}"] = q + s * 2 * kv
        plan[f"v{s}"] = q + s * 2 * kv + kv
    plan["bytes"] = plan["bar"] + (2 + 4 * st) * 8 + 1024
    return plan


# ---------------------------------------------------------------------------
# the work: items, KV tiles, masks (item_at, walk, kv_tiles, tile_needs_mask)
# ---------------------------------------------------------------------------

def item_at(t, b, h, tiles_m):
    """(b, h, q0) of item t: query tiles from the last, then b, h fastest."""
    bh = b * h
    r = t % bh
    return r // h, r % h, (tiles_m - 1 - t // bh) * BM


def walk(blk, grid, items):
    """The items block ``blk`` takes, in order: round n of ``grid`` items
    walked forwards on even rounds, backwards on odd ones."""
    out = []
    n = 0
    while n * grid < items:
        t = n * grid + (grid - 1 - blk if n & 1 else blk)
        if t < items:
            out.append(t)
        n += 1
    return out


def kv_tiles(q0, s, causal, window):
    kv_end = min(q0 + BM, s) if causal else s
    kv_begin = max(0, q0 - window + 1) if window > 0 else 0
    return kv_begin // BN, -(-kv_end // BN)


def tile_needs_mask(r0, k0, s, causal, window):
    return (k0 + BN > s or (causal and k0 + BN - 1 > r0)
            or (window > 0 and k0 <= r0 + 63 - window))


def dense_mask(rows, cols, s, causal, window):
    """The reference's mask: key < S, key <= row (causal), key > row -
    window (window > 0)."""
    r, c = np.meshgrid(rows, cols, indexing="ij")
    ok = c < s
    if causal:
        ok &= c <= r
    if window:
        ok &= c > r - window
    return ok


@pytest.mark.parametrize("s", [40, 1000, 1023, 2048])   # 1023: one key short
@pytest.mark.parametrize("window", [0, 8, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_classes_match_the_dense_mask(causal, window, s):
    """Tiles outside [j0, j1) are masked for every row of the item; a tile
    is left unmasked exactly when the dense mask keeps all of its (row,
    key) pairs over the warpgroup's 64 rows; every loaded tile holds a pair
    some row below S keeps."""
    n_tiles = -(-s // BN)
    for q0 in range(0, s, BM):
        j0, j1 = kv_tiles(q0, s, causal, window)
        assert 0 <= j0 < j1 <= n_tiles
        item_rows = np.arange(q0, min(q0 + BM, s))
        for j in range(n_tiles):
            keys = np.arange(j * BN, j * BN + BN)
            ok = dense_mask(item_rows, keys, s, causal, window)
            if not j0 <= j < j1:
                assert not ok.any(), (q0, j)
                continue
            assert ok.any(), (q0, j)
            for wg in range(2):
                r0 = q0 + 64 * wg
                full = dense_mask(np.arange(r0, r0 + 64), keys, s, causal,
                                  window)
                assert tile_needs_mask(r0, j * BN, s, causal, window) == \
                    (not full.all()), (q0, j, wg)


SHAPES = [(4, 64, 12), (8, 1024, 12), (1, 2048, 48), (1, 6144, 48),
          (8, 512, 16), (4, 2048, 32), (2, 1000, 48), (3, 300, 5),
          (1, 2048, 40), (4, 2048, 64), (4, 2048, 16)]


@pytest.mark.parametrize("b,s,h", SHAPES)
def test_persistent_walk_covers_every_item_once(b, s, h):
    """Every (b, h, q-tile) once over the blocks of the grid, longest
    first: each block's items under causal have non-increasing key
    counts, and the first round holds the last query tiles."""
    tiles_m = -(-s // BM)
    items = b * h * tiles_m
    grid = min(items, SMS)
    seen = {}
    for blk in range(grid):
        ts = walk(blk, grid, items)
        q0s = [item_at(t, b, h, tiles_m)[2] for t in ts]
        assert q0s == sorted(q0s, reverse=True)
        for t in ts:
            key = item_at(t, b, h, tiles_m)
            assert 0 <= key[0] < b and 0 <= key[1] < h and 0 <= key[2] < s
            seen[key] = seen.get(key, 0) + 1
    assert len(seen) == items and set(seen.values()) == {1}
    first = {item_at(t, b, h, tiles_m)[2] for t in range(min(grid, b * h))}
    assert first == {(tiles_m - 1) * BM}


def test_query_heads_of_a_kv_head_are_neighbours():
    """Consecutive items share (b, q-tile) and walk h, so the H / KV query
    heads of one KV head follow each other (mixtral: 48 / 8)."""
    b, h, kvh, tiles_m = 1, 48, 8, 16
    kv_heads = [item_at(t, b, h, tiles_m)[1] // (h // kvh)
                for t in range(b * h)]
    assert kv_heads == sorted(kv_heads)


@pytest.mark.parametrize("h,kvh", [(40, 8), (48, 1), (32, 8), (64, 8)])
def test_query_heads_of_a_kv_head_are_neighbours_at_odd_groups(h, kvh):
    """The same at llama4's 40 / 8 (5 query heads a KV head), granite's
    MQA 48 / 1, qwen3's 32 / 8 and qwen2-72b's 64 / 8: each KV head's
    query heads are one run of H / KV consecutive items."""
    b, tiles_m = 1, 16
    kv_heads = [item_at(t, b, h, tiles_m)[1] // (h // kvh)
                for t in range(b * h)]
    assert kv_heads == [i // (h // kvh) for i in range(h)]


# ---------------------------------------------------------------------------
# shared memory, TMA boxes, descriptors, fragments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
def test_shared_memory_plan_fits_and_aligns(hd):
    plan = smem_plan(hd)
    assert plan["bytes"] <= SMEM_MAX
    tiles = sorted((v, k) for k, v in plan.items()
                   if k not in ("bar", "bytes"))
    sizes = {"q": BM * hd * 2, "o": BM * hd * 2}
    for (off, name), nxt in zip(tiles, tiles[1:] + [(plan["bar"], "bar")]):
        assert off % 1024 == 0                 # the swizzle's atom
        size = sizes.get(name, BN * hd * 2)
        assert off + size == nxt[0], (name, off, size)


def tma_load_4d(smem, dst, glob, c0, h, r0, b, rows):
    """TMA load of the box {64, 1, rows, 1} at (c0, h, r0, b) of ``glob``
    [B, S, heads, hd] (bf16, 2-byte elements) into shared memory at
    ``dst`` with the 128-byte swizzle; out of bounds reads 0."""
    assert dst % 1024 == 0
    r, i = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    gr, gi = r0 + r, c0 + i
    inb = (gr < glob.shape[1]) & (gi < glob.shape[3])
    vals = np.where(inb, glob[b, np.minimum(gr, glob.shape[1] - 1), h,
                              np.minimum(gi, glob.shape[3] - 1)], 0.0)
    smem[(dst + sw128(r * 128 + i * 2)) // 2] = vals


def tma_store_4d(glob, smem, src, c0, h, r0, b):
    """TMA store of the box {64, 1, 64, 1} at (c0, h, r0, b): shared
    memory at ``src`` (128-byte swizzle) into ``glob``; rows >= S are not
    written."""
    r, i = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    vals = smem[(src + sw128(r * 128 + i * 2)) // 2]
    keep = r0 + r[:, 0] < glob.shape[1]
    glob[b, r0 + np.arange(64)[keep], h, c0:c0 + 64] = vals[keep]


@pytest.mark.parametrize("heads,kvh,s", [(48, 8, 300), (12, 12, 64),
                                         (4, 1, 129), (40, 8, 300),
                                         (48, 1, 129)])
@pytest.mark.parametrize("hd", [64, 128])
def test_tma_boxes_pick_rows_and_the_gqa_head(hd, heads, kvh, s):
    """The producer's boxes: Q at (64 c, h, q0, b), K / V at (64 c,
    h // (H/KV), j BN, b); rows past S read as 0; the store writes rows
    below S only."""
    rng = np.random.RandomState(hd + heads + s)
    b = 2
    q = rng.randn(b, s, heads, hd).astype(np.float32)
    k = rng.randn(b, s, kvh, hd).astype(np.float32)
    for bb, h, q0 in itertools.product(range(b), (0, heads - 1),
                                       range(0, s, BM)):
        kh = h // (heads // kvh)
        for glob, head, rows in ((q, h, BM), (k, kh, BN)):
            smem = np.full(rows * hd, np.nan, np.float32)
            for c in range(hd // 64):
                tma_load_4d(smem, c * rows * 128, glob, 64 * c, head, q0, bb,
                            rows)
            got = np.concatenate(
                [read_kmajor(smem, 2, c * rows * 128, rows, 64)
                 for c in range(hd // 64)], axis=1)
            want = np.zeros((rows, hd), np.float32)
            n = min(rows, s - q0)
            want[:n] = glob[bb, q0:q0 + n, head]
            np.testing.assert_array_equal(got, want)
    # the store clips: the box at rows s - 10 .. s + 53 writes 10 rows
    out = np.zeros((1, s, heads, hd), np.float32)
    smem = np.arange(1, 64 * 64 + 1, dtype=np.float32)
    tma_store_4d(out, smem, 0, 0, 1, s - 10, 0)
    assert np.count_nonzero(out[0, :, 1, :64]) == 10 * 64
    assert not out[0, :s - 10].any()


def pack_p():
    """pack_p: pa[c][j] = (sc[8c + 2j], sc[8c + 2j + 1]), the register
    indices of the accumulator behind each half of each A register."""
    return [[(8 * c + 2 * j, 8 * c + 2 * j + 1) for j in range(4)]
            for c in range(BN // 16)]


@pytest.mark.parametrize("hd", [64, 128])
def test_accumulator_is_the_a_fragment_of_p_v(hd):
    """Every (row, key) of the 64 x 128 S tile sits in one accumulator
    register, and packing it as pack_p does puts it where the A fragment of
    k16 step key // 16 expects (row, key % 16); the 64 x hd O accumulator
    covers its tile once too."""
    seen = np.zeros((64, BN), np.int64)
    for t in range(128):
        regs = pack_p()
        for c, j, half in itertools.product(range(BN // 16), range(4),
                                            range(2)):
            row, col = acc_pos(t, regs[c][j][half])
            arow, ak = a_frag_pos(t, j, half)
            assert (row, col) == (arow, 16 * c + ak)
            seen[row, col] += 1
    assert (seen == 1).all()
    seen_o = np.zeros((64, hd), np.int64)
    for t, i in itertools.product(range(128), range(hd // 2)):
        seen_o[acc_pos(t, i)] += 1
    assert (seen_o == 1).all()


def p_to_a():
    """For each k16 step c: the (row, k) of every A-fragment half and the
    (row, key) of the accumulator register pack_p puts there."""
    regs = pack_p()
    idx = np.zeros((BN // 16, 4, 128 * 8), np.int64)
    for c in range(BN // 16):
        n = 0
        for t, j, half in itertools.product(range(128), range(4), range(2)):
            idx[c, :, n] = a_frag_pos(t, j, half) + acc_pos(t, regs[c][j][half])
            n += 1
    return idx


P_TO_A = p_to_a()


def epilogue_store(o_tile, smem, base):
    """The epilogue's writes: register pair (i, i + 1) of thread t to byte
    (rr 128 + (col % 64) 2) swizzled, in the 64-column box col // 64, boxes
    8192 bytes apart."""
    hd = o_tile.shape[1]
    for t in range(128):
        for i in range(0, hd // 2, 2):
            rr, col = acc_pos(t, i)
            off = rr * 128 + (col % 64) * 2
            addr = base + (col // 64) * 64 * 128 + sw128(off)
            smem[addr // 2:addr // 2 + 2] = o_tile[rr, col:col + 2]


def model_attention(q, k, v, causal, window):
    """The kernel's item and tile loop, one block: boxes loaded into the
    shared-memory plan (stage ring included), S = Q K^T through the K-major
    descriptors, the masks of the classified tiles, the online softmax in
    float32 with ex2 and the FMA fold, P V from the A fragments and the
    transposed V descriptor, the epilogue's writes and the TMA store."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    plan, st = smem_plan(hd), STAGES
    smem = np.full(plan["bytes"] // 2, np.nan, np.float32)
    c = np.float32(hd ** -0.5 * np.log2(np.e))
    tiles_m = -(-s // BM)
    out = np.full(q.shape, np.nan, np.float32)
    it = 0
    for t in walk(0, 1, b * h * tiles_m):
        bb, hh, q0 = item_at(t, b, h, tiles_m)
        kh = hh // (h // kvh)
        for cb in range(hd // 64):
            tma_load_4d(smem, plan["q"] + cb * BM * 128, q, 64 * cb, hh, q0,
                        bb, BM)
        j0, j1 = kv_tiles(q0, s, causal, window)
        state = [dict(m=np.full(64, MASK), l=np.zeros(64, np.float32),
                      o=np.zeros((64, hd), np.float32)) for _ in range(2)]
        for j in range(j0, j1):
            ks, vs = plan[f"k{it % st}"], plan[f"v{it % st}"]
            for cb in range(hd // 64):
                tma_load_4d(smem, ks + cb * BN * 128, k, 64 * cb, kh, j * BN,
                            bb, BN)
                tma_load_4d(smem, vs + cb * BN * 128, v, 64 * cb, kh, j * BN,
                            bb, BN)
            it += 1
            for wg, z in enumerate(state):
                r0 = q0 + 64 * wg
                sc = np.zeros((64, BN), np.float32)
                for kk in range(hd // 16):
                    fa = read_kmajor(smem, 2, plan["q"] + wg * 64 * 128
                                     + (kk // 4) * BM * 128 + (kk % 4) * 32,
                                     64, 16)
                    fb = read_kmajor(smem, 2, ks + (kk // 4) * BN * 128
                                     + (kk % 4) * 32, BN, 16)
                    sc += fa @ fb.T
                if tile_needs_mask(r0, j * BN, s, causal, window):
                    ok = dense_mask(np.arange(r0, r0 + 64),
                                    np.arange(j * BN, j * BN + BN), s,
                                    causal, window)
                    sc = np.where(ok, sc, MASK)
                mx = np.maximum(z["m"], sc.max(1))
                alpha = np.exp2((z["m"] - mx) * c)
                p = np.exp2(sc * c - (mx * c)[:, None]).astype(np.float32)
                z["m"], z["l"] = mx, z["l"] * alpha + p.sum(1)
                z["o"] *= alpha[:, None]
                # P through the registers: accumulator -> A fragments
                for cs in range(BN // 16):
                    a = np.full((64, 16), np.nan, np.float32)
                    ar, ak, pr, pc = P_TO_A[cs]
                    a[ar, ak] = p[pr, pc]
                    fv = read_mnmajor(smem, 2, vs + cs * 2048, hd, 16,
                                      lbo=BN * 128)
                    z["o"] += a @ fv.T
        for wg, z in enumerate(state):
            base = plan["o"] + wg * (hd // 64) * 64 * 128
            epilogue_store(z["o"] / np.maximum(z["l"], 1e-30)[:, None], smem,
                           base)
            r0 = q0 + 64 * wg
            if r0 < s:
                for cb in range(hd // 64):
                    tma_store_4d(out, smem, base + cb * 64 * 128, 64 * cb, hh,
                                 r0, bb)
    return out


def dense_attention(q, k, v, causal, window):
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    kk = np.repeat(k, rep, axis=2).astype(np.float64)
    vv = np.repeat(v, rep, axis=2).astype(np.float64)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) \
        * hd ** -0.5
    ok = dense_mask(np.arange(s), np.arange(s), s, causal, window)
    logits = np.where(ok, logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("causal,window,s", [(True, 0, 200), (True, 96, 300),
                                             (False, 0, 40),
                                             (False, 64, 200)])
@pytest.mark.parametrize("hd", [64, 128])
def test_kernel_model_matches_dense_attention(hd, causal, window, s):
    rng = np.random.RandomState(hd + s + window)
    b, h, kvh = 1, 4, 2
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(b, s, kvh, hd).astype(np.float32)
    v = rng.randn(b, s, kvh, hd).astype(np.float32)
    got = model_attention(q, k, v, causal, window)
    np.testing.assert_allclose(got, dense_attention(q, k, v, causal, window),
                               rtol=1e-4, atol=1e-5)


def test_masked_row_cancels_exactly():
    """A row whose keys are all masked so far: the FMA of -2^100 against
    the running max -2^100 is exactly 0 (ex2 gives 1, as the TPU kernel's
    exp(-1e30 - -1e30)), and the next tile's first unmasked key wipes it
    (alpha 0)."""
    c = np.float32(64 ** -0.5 * np.log2(np.e))
    mc = np.float32(MASK * c)
    assert np.float32(MASK) * c - mc == 0.0
    assert np.exp2(np.float32((MASK - np.float32(3.0)) * c)) == 0.0


@pytest.mark.parametrize("h,kvh", [(10, 2), (6, 1)])
def test_kernel_model_matches_dense_attention_at_odd_groups(h, kvh):
    """The kernel model at GQA groups of 5 (llama4's 40 / 8) and of all
    heads (granite's MQA), hd 128, causal, a ragged last tile."""
    rng = np.random.RandomState(h)
    b, s, hd = 1, 150, 128
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(b, s, kvh, hd).astype(np.float32)
    v = rng.randn(b, s, kvh, hd).astype(np.float32)
    got = model_attention(q, k, v, True, 0)
    np.testing.assert_allclose(got, dense_attention(q, k, v, True, 0),
                               rtol=1e-4, atol=1e-5)
