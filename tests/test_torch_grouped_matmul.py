"""``grouped_matmul``'s Hopper kernel (``csrc/grouped_matmul.cu``), the
parts the CPU can reach: the TMA's 16-byte operand rule, the planner that
picks the kernel and the operand kinds, and numpy models of the kernel's
index arithmetic — the TMA boxes and their 128-byte swizzle, the wgmma
shared-memory descriptors (start address, leading / stride byte offsets),
the transform stage's K-major swizzled writes, tf32 rounding, the
persistent tile walk and the accumulator fragment of the epilogue —
multiplied out and held against
``np.matmul``.  The models repeat the source's constants; the kernel
itself runs only on the card (``chip_smoke.py`` phase 1).

Tolerances: the layout models move float32 values without arithmetic
and sum in float64 (rtol 1e-5, atol 1e-5: another order); the tf32 rounding
check holds its product to the card's limit, 2e-3 of the largest output.
"""
import itertools

import numpy as np
import pytest
import torch
from _tma_model import read_kmajor, read_mnmajor, tma_box

from repro_torch.configs import get_config
from repro_torch.core.gating import capacity
from repro_torch.kernels.moe_ffn import (KIND_BF16, KIND_MN_MAJOR, _layout,
                                         grouped_matmul, mm_plan,
                                         tma_operand_rule)

# (a_bf16, b_bf16, a_t, b_t)
MIXES = list(itertools.product((True, False), repeat=4))


# ---------------------------------------------------------------------------
# the 16-byte operand rule
# ---------------------------------------------------------------------------

def backward_operands(e, c, d, f, swiglu):
    """(name, logical shape, transposed, itemsize) of every operand of the
    FFN backward's grouped GEMMs (ops._GroupedFFN.backward)."""
    bf, fp = 2, 4
    ops = [("h: x", (e, c, d), False, bf),
           ("h: wi", (e, d, f), False, bf),
           ("da: dy", (e, c, d), False, fp),
           ("da: wo^T", (e, d, f), True, bf),
           ("dwo: act^T", (e, f, c), True, fp),
           ("dwo: dy", (e, c, d), False, fp),
           ("dx: dh", (e, c, f), False, fp),
           ("dx: wi^T", (e, f, d), True, bf),
           ("dwi: x^T", (e, d, c), True, bf),
           ("dwi: dh", (e, c, f), False, fp)]
    if swiglu:
        ops += [("u: wu", (e, d, f), False, bf),
                ("dx: du", (e, c, f), False, fp),
                ("dx: wu^T", (e, f, d), True, bf),
                ("dwu: x^T", (e, d, c), True, bf)]
    return ops


@pytest.mark.parametrize("arch", ["gpt2-moe", "gpt2-moe-smoke",
                                  "mixtral-8x22b"])
@pytest.mark.parametrize("tokens", [8192, 37, 1])
def test_rule_holds_for_every_backward_operand(arch, tokens):
    cfg = get_config(arch)
    e = cfg.moe.n_experts
    c = capacity(tokens, e, 2, 1.25)
    ops = backward_operands(e, c, cfg.d_model, cfg.d_ff,
                            cfg.ffn_type == "swiglu")
    for name, shape, tr, size in ops:
        tma_operand_rule(name, shape, tr, size, 256 * 1024)
    # the capacity only ever counts rows: an odd one passes too
    for name, shape, tr, size in backward_operands(e, 1289, cfg.d_model,
                                                   cfg.d_ff, False):
        tma_operand_rule(name, shape, tr, size)


@pytest.mark.parametrize("shape,transposed,itemsize,ptr", [
    ((2, 5, 12), False, 2, 0),     # 12 bf16 = 24 bytes a row
    ((2, 5, 6), False, 4, 0),      # 6 fp32 = 24 bytes
    ((2, 1289, 64), True, 4, 0),   # stored [2, 64, 1289]: M contiguous
    ((3, 7, 64), False, 2, 8),     # rows fine, the base 8-byte aligned
])
def test_rule_refuses(shape, transposed, itemsize, ptr):
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tma_operand_rule("a", shape, transposed, itemsize, ptr)


def test_rule_reads_the_stored_contiguous_dimension():
    tma_operand_rule("b", (2, 200, 1289), True, 2)    # stored [2, 1289, 200]
    with pytest.raises(ValueError):
        tma_operand_rule("b", (2, 200, 1289), False, 2)


def test_zero_size_results_on_cpu():
    out = grouped_matmul(torch.zeros(2, 0, 8), torch.zeros(2, 8, 4))
    assert out.shape == (2, 0, 4) and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_bf16,b_bf16,a_t,b_t", MIXES)
def test_plan_over_every_mix(a_bf16, b_bf16, a_t, b_t):
    plan = mm_plan(a_bf16, b_bf16, a_t, b_t)
    assert plan.kernel == ("bf16" if a_bf16 and b_bf16 else "tf32")
    assert bool(plan.a_kind & KIND_BF16) == a_bf16
    assert bool(plan.b_kind & KIND_BF16) == b_bf16
    # a is M-major when stored transposed; b is N-major when row-major
    assert bool(plan.a_kind & KIND_MN_MAJOR) == a_t
    assert bool(plan.b_kind & KIND_MN_MAJOR) == (not b_t)
    # the layout flags the wrapper derives from real tensors agree
    a = torch.zeros(2, 24, 16).transpose(1, 2) if a_t \
        else torch.zeros(2, 16, 24)
    b = torch.zeros(2, 8, 24).transpose(1, 2) if b_t \
        else torch.zeros(2, 24, 8)
    assert _layout(a)[1] == a_t and _layout(b)[1] == b_t


def test_plan_covers_the_five_training_gemms():
    # h, da, dwo, dx, dwi as ops._GroupedFFN.backward calls them
    want = {(True, True, False, False): ("bf16", 1, 3),
            (False, True, False, True): ("tf32", 0, 1),
            (False, False, True, False): ("tf32", 2, 2),
            (True, False, True, False): ("tf32", 3, 2)}
    for mix, plan in want.items():
        assert tuple(mm_plan(*mix)) == plan


# ---------------------------------------------------------------------------
# numpy models of the kernel's shared-memory layouts
# ---------------------------------------------------------------------------

BM = 128
BF_N, BF_K = 256, 64          # bf16 kernel tile and stage depth
TF_N, TF_K = 256, 32          # tf32 kernel tile and stage depth


def bf16_tile(a_stored, b_stored, am, bn, m0, n0, k):
    """The bf16 kernel's 128 x 256 output tile at (m0, n0) of one group,
    stage by stage as the producer loads and the two consumer warpgroups
    multiply (gmm_bf16_kernel)."""
    es, a_bytes = 2, BM * BF_K * 2
    out = np.zeros((BM, BF_N))
    for k0 in range(0, k, BF_K):
        smem = np.full((a_bytes + BF_N * BF_K * 2) // es, np.nan)
        a, b = 0, a_bytes
        if am:
            tma_box(smem, es, a, a_stored, m0, k0, 64, 64, True)
            tma_box(smem, es, a + a_bytes // 2, a_stored, m0 + 64, k0, 64,
                    64, True)
        else:
            tma_box(smem, es, a, a_stored, k0, m0, BF_K, BM, True)
        if bn:
            for j in range(4):
                tma_box(smem, es, b + j * 8192, b_stored, n0 + 64 * j, k0, 64,
                        64, True)
        else:
            tma_box(smem, es, b, b_stored, k0, n0, BF_K, BF_N, True)
        assert not np.isnan(smem).any()     # the boxes fill the stage
        for wg in range(2):
            aw = a + wg * (a_bytes // 2)
            for kk in range(BF_K // 16):
                fa = read_mnmajor(smem, es, aw + kk * 2048, 64, 16,
                                  a_bytes // 2) \
                    if am else read_kmajor(smem, es, aw + kk * 32, 64, 16)
                fb = read_mnmajor(smem, es, b + kk * 2048, BF_N, 16, 8192) \
                    if bn else read_kmajor(smem, es, b + kk * 32, BF_N, 16)
                out[64 * wg:64 * wg + 64] += fa @ fb.T
    return out


def stored(x, mn_major):
    """The 2-D array as stored: x [rows, k] itself (K-major) or its
    transpose [k, rows] (M/N-major)."""
    return np.ascontiguousarray(x.T) if mn_major else x


@pytest.mark.parametrize("am,bn", list(itertools.product((False, True),
                                                         repeat=2)))
def test_bf16_layout_model_multiplies(am, bn):
    rng = np.random.RandomState(int(am) * 2 + int(bn))
    m, n, k = 150, 300, 136        # ragged in every tile dimension
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    a_st, b_st = stored(a, am), stored(b.T, bn)
    got = np.zeros((m, n))
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BF_N):
            t = bf16_tile(a_st, b_st, am, bn, m0, n0, k)
            got[m0:m0 + BM, n0:n0 + BF_N] = t[:m - m0, :n - n0]
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=1e-5,
                               atol=1e-5)


def tf32_round(x):
    """cvt.rna.tf32.f32: to nearest, ties away from zero, on the 13 low
    mantissa bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def transform(raw, kind, rows):
    """The transform stage (csrc load_chunks / store_chunks): a raw rows x
    32 stage, [rows][32] K-major or [32][rows] M/N-major, into the K-major
    swizzled fp32 tile, as 4-byte words; rows / 32 chunks each of 256
    threads."""
    conv = np.full(rows * TF_K, np.nan, np.float32)
    for tid in range(256):
        for u in range(rows // 32):
            item = tid + 256 * u
            if kind & KIND_MN_MAJOR:
                r, j = item % rows, item // rows
                v = raw[4 * j:4 * j + 4, r]
            else:
                r, j = item >> 3, item & 7
                v = raw[r, 4 * j:4 * j + 4]
            if not kind & KIND_BF16:
                v = tf32_round(v)
            word = (128 * r + 16 * (j ^ (r & 7))) // 4
            conv[word:word + 4] = v
    return conv


def tf32_tile(a_stored, b_stored, a_kind, b_kind, m0, n0, k):
    """The tf32 kernel's 128 x 256 tile (gmm_tf32_kernel): raw unswizzled
    boxes, the transform, then wgmma k8 slices on the K-major tiles."""
    out = np.zeros((BM, TF_N))
    am, bn = a_kind & KIND_MN_MAJOR, b_kind & KIND_MN_MAJOR
    for k0 in range(0, k, TF_K):
        tiles = []
        for st, mn, kind, r0, rows in ((a_stored, am, a_kind, m0, BM),
                                       (b_stored, bn, b_kind, n0, TF_N)):
            es = 2 if kind & KIND_BF16 else 4
            raw = np.full(rows * TF_K, np.nan)
            if mn:
                tma_box(raw, es, 0, st, r0, k0, rows, TF_K, False)
                raw = raw.reshape(TF_K, rows)
            else:
                tma_box(raw, es, 0, st, k0, r0, TF_K, rows, False)
                raw = raw.reshape(rows, TF_K)
            tiles.append(transform(raw.astype(np.float32), kind, rows))
        conv_a, conv_b = tiles
        assert not np.isnan(conv_a).any() and not np.isnan(conv_b).any()
        for wg in range(2):
            for kk in range(TF_K // 8):
                fa = read_kmajor(conv_a, 4, wg * 8192 + kk * 32, 64, 8)
                fb = read_kmajor(conv_b, 4, kk * 32, TF_N, 8)
                out[64 * wg:64 * wg + 64] += fa.astype(np.float64) @ fb.T
    return out


@pytest.mark.parametrize("a_kind,b_kind", [(0, 1), (2, 2), (3, 2), (1, 0),
                                           (0, 3), (2, 1)])
def test_tf32_layout_model_multiplies(a_kind, b_kind):
    rng = np.random.RandomState(10 * a_kind + b_kind)
    m, n, k = 140, 264, 72       # ragged in every tile dimension
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    if a_kind & KIND_BF16:
        a = torch.from_numpy(a).bfloat16().float().numpy()
    if b_kind & KIND_BF16:
        b = torch.from_numpy(b).bfloat16().float().numpy()
    a_st = stored(a, a_kind & KIND_MN_MAJOR)
    b_st = stored(b.T, b_kind & KIND_MN_MAJOR)
    got = np.zeros((m, n))
    for m0 in range(0, m, BM):
        for n0 in range(0, n, TF_N):
            t = tf32_tile(a_st, b_st, a_kind, b_kind, m0, n0, k)
            got[m0:m0 + BM, n0:n0 + TF_N] = t[:m - m0, :n - n0]
    want_a = a if a_kind & KIND_BF16 else tf32_round(a)
    want_b = b if b_kind & KIND_BF16 else tf32_round(b)
    np.testing.assert_allclose(got, want_a.astype(np.float64) @ want_b,
                               rtol=1e-5, atol=1e-5)


def test_tf32_rounding_is_to_nearest_and_within_the_limit():
    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32)
    r = tf32_round(x)
    assert not (r.view(np.uint32) & 0x1FFF).any()        # 10-bit mantissa
    assert np.all(np.abs(r - x) <= np.abs(x) * 2.0 ** -11 * (1 + 1e-6))
    # bf16 values pass unchanged (tf32 holds bf16's 7-bit mantissa)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(tf32_round(xb), xb)
    # a 1288-deep product of rounded fp32 operands, as dwo: well inside the
    # card's 2e-3 limit of max |error| / max |result|
    a = rng.randn(64, 1288).astype(np.float32)
    b = rng.randn(1288, 64).astype(np.float32)
    want = a.astype(np.float64) @ b
    got = tf32_round(a).astype(np.float64) @ tf32_round(b)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-3 / 4


@pytest.mark.parametrize("n", [128, 256])
def test_accumulator_fragment_covers_the_tile_once(n):
    """store_tile: register i of thread (warp w, lane l) holds row 16 w +
    l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2."""
    seen = np.zeros((64, n), np.int64)
    for t in range(128):
        w, l = t >> 5, t & 31
        for i in range(n // 2):
            r = 16 * w + (l >> 2) + 8 * ((i >> 1) & 1)
            c = 8 * (i >> 2) + 2 * (l & 3) + (i & 1)
            seen[r, c] += 1
    assert (seen == 1).all()


def tile_at(t, tiles_n, tiles_m, bn):
    """csrc tile_at: (group, m0, n0) of tile t, N tiles fastest."""
    n0 = (t % tiles_n) * bn
    t //= tiles_n
    return t // tiles_m, (t % tiles_m) * BM, n0


@pytest.mark.parametrize("g,m,n,bn,grid", [(16, 1288, 3072, 256, 132),
                                           (16, 3072, 768, 256, 132),
                                           (3, 37, 200, 128, 132),
                                           (1, 1289, 201, 256, 5)])
def test_persistent_walk_covers_every_tile_once(g, m, n, bn, grid):
    tiles_n, tiles_m = -(-n // bn), -(-m // BM)
    tiles = tiles_n * tiles_m * g
    blocks = min(tiles, grid)
    seen = {}
    for blk in range(blocks):
        for t in range(blk, tiles, blocks):
            gg, m0, n0 = tile_at(t, tiles_n, tiles_m, bn)
            assert 0 <= gg < g and 0 <= m0 < m and 0 <= n0 < n
            seen[(gg, m0, n0)] = seen.get((gg, m0, n0), 0) + 1
    assert len(seen) == tiles and set(seen.values()) == {1}
