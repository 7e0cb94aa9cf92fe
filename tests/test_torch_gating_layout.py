"""``topk_gating_fused``'s Hopper kernel (``csrc/topk_gating.cu``) and
``combine_rows``' (``csrc/dispatch.cu``), the parts the CPU can reach:
numpy models of their layouts and of their arithmetic.

The gating model follows one block: x's [64 rows, 64 k] TMA boxes with the
128-byte swizzle, the router's [64 k, N] slice zero-padded to N and
swizzled over its row (32, 64 or 128 bytes; by TMA boxes where E % 8 ==
0, else by the threads' staged writes over a slice zeroed once), what
``wgmma`` reads through the K-major and N-major
descriptors, where each register of the m64nN accumulator sits
(``_tma_model.acc_pos``), and the epilogue on those registers: the bf16
rounding, the quad max, exp and sum, and the k rounds of a quad arg-max on
(value, lower index).  It is multiplied out against ``ref_topk_gating``
and the reference's Pallas kernel in interpret mode at E in {3, 8, 16,
128} (and, against the plain version, 40 and 256), k in {1, 2}, with a
ragged T and D, exact ties and rows whose every probability but one
underflows to 0, and split over a cluster's CTAs.  A value-only quad
arg-max, the counter-case, takes the wrong expert on a tie.  The combine
model is the kernel's split of a row into 16-byte vectors: lanes, the
choices' loads in flight, the sums in choice order, dropped choices and a
row's last vector.  The models read their constants from the sources; the
kernels themselves run only on the card (``chip_smoke.py`` phase 1).

Inputs are small multiples of powers of two, so every product and sum is
exact in float32 and every route rounds the same logits to bf16: ids are
held exactly and probabilities within 1e-6 (float32 exp and division in
another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tma_model import acc_pos, read_kmajor, read_mnmajor, tma_box

from repro.kernels.topk_gating import topk_gating_fused as j_gating
from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
GATING = (CSRC / "topk_gating.cu").read_text()
DISPATCH = (CSRC / "dispatch.cu").read_text()


def constant(name: str, text: str = GATING) -> int:
    """The integer literal a ``constexpr int`` of the source is set to."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)", text)
    assert len(found) == 1, f"{name} set {len(found)}x"
    return int(found[0])


BM, BK, THREADS = constant("kBM"), constant("kBK"), constant("kConsumers")
RBLOCK, RING_MAX = constant("kRBlock"), constant("kRingMax")
MAX_E, MAX_K = constant("kMaxE"), constant("kMaxK")
MAX_SPLITS = constant("kMaxSplits")
MIN_SPLIT_STEPS = constant("kMinSplitSteps")
X_STAGE = BM * BK * 2
SMEM_LIMIT = 232448            # a block's dynamic shared memory on Hopper


def width(e: int) -> int:
    """The product's N: E rounded up to 16, 32, 64, 128 or 256."""
    return next(n for n in (16, 32, 64, 128, 256) if e <= n)


def row_bytes(n: int) -> int:
    """Slice<N>::kRow: a router slice row's bytes, the swizzle's span."""
    return min(n, 64) * 2


def slice_bytes(n: int) -> int:
    return BK * row_bytes(n) if n < 64 else n // 64 * RBLOCK


def ring(n: int):
    """(stage bytes, stages, shared memory) of Ring<N>."""
    stage = X_STAGE + slice_bytes(n)
    stages = min(16, RING_MAX // stage)
    return stage, stages, stages * stage + 1024 + stages * 16


def swizzle(addr, span: int):
    """The 32-, 64- or 128-byte swizzle (TMA and wgmma alike): the 16-byte
    chunk bits [4, 4 + b) XOR address bits [7, 7 + b), span = 16 * 2^b."""
    return addr ^ (((addr >> 7) & (span // 16 - 1)) << 4)


def tma_box_span(smem, es, dst, glob, c0, c1, box0, box1):
    """TMA load of a {box0, box1} box at (c0, c1) of the 2-D ``glob``
    [outer, inner], its rows of box0 * es bytes swizzled over that span;
    out of bounds reads 0."""
    span = box0 * es
    j, i = np.meshgrid(np.arange(box1), np.arange(box0), indexing="ij")
    gi, gj = c0 + i, c1 + j
    inb = (gi < glob.shape[1]) & (gj < glob.shape[0])
    vals = np.where(inb, glob[np.minimum(gj, glob.shape[0] - 1),
                              np.minimum(gi, glob.shape[1] - 1)], 0.0)
    assert dst % (8 * span) == 0
    smem[(dst + swizzle((j * box0 + i) * es, span)) // es] = vals


def read_nmajor(smem, es, start, n, kw, span, lbo, sbo):
    """What wgmma reads through an N-major descriptor of a ``span``-byte
    swizzle: [n, kw]; rows of ``span`` bytes along n, ``span // es``-wide
    blocks ``lbo`` apart, k rows ``span`` apart in 8-row groups ``sbo``
    apart."""
    w = span // es
    x, k = np.meshgrid(np.arange(n), np.arange(kw), indexing="ij")
    addr = start + (x % w) * es + (x // w) * lbo + (k % 8) * span \
        + (k // 8) * sbo
    return smem[swizzle(addr, span) // es]


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def test_ring_fits_and_keeps_bytes_in_flight():
    assert (BM, BK, THREADS, RBLOCK) == (64, 64, 128, 8192)
    assert constant("kThreads") == THREADS + 32      # + the producer warp
    assert (MAX_E, MAX_K) == (256, 4)
    for n in (16, 32, 64, 128, 256):
        stage, stages, smem = ring(n)
        assert smem <= SMEM_LIMIT and stage % 1024 == 0
        # >= 40 KB of x in flight: 8-16 stages up to N 128, 5 at 256
        assert stages >= 5 and stages * X_STAGE >= 40 * 1024
    assert ring(16)[1] == 16 and ring(128)[1] == 8
    # a quad holds a row's N columns, one choice a thread
    assert MAX_K <= 4


# ---------------------------------------------------------------------------
# the product: TMA boxes, the zero-padded router stage, the descriptors
# ---------------------------------------------------------------------------

def router_off(k, col, n):
    """csrc/topk_gating.cu::router_off<N>: byte offset of router element
    (k, col) in a stage's slice."""
    rb = row_bytes(n)
    o = k * rb + (col & 63) * 2
    return (col >> 6) * RBLOCK + swizzle(o, rb)


def stage_router(smem, base, router, k0, n, tma: bool):
    """One stage's router slice into ``smem`` at byte ``base``."""
    d, e = router.shape
    if tma:
        for j in range(-(-n // 64)):
            tma_box_span(smem, 2, base + j * RBLOCK, router, 64 * j, k0,
                         min(n, 64), BK)
        return
    # the threads' staged writes: only the real columns, rows past D zero;
    # the blocks were zeroed once at the start
    for tid in range(THREADS):
        for i in range(tid, BK * e, THREADS):
            kr, col = divmod(i, e)
            smem[(base + router_off(kr, col, n)) // 2] = \
                router[k0 + kr, col] if k0 + kr < d else 0.0


def choose_splits(t: int, d: int, e: int, sms: int = 132) -> int:
    """launch_gating's split of a tile's k steps over a cluster (N <= 128
    only): doubled while the tiles leave half the SMs idle and each CTA
    keeps MIN_SPLIT_STEPS steps."""
    tiles, steps, splits = -(-t // BM), -(-d // BK), 1
    while width(e) <= 128 and splits < MAX_SPLITS \
            and tiles * splits * 2 <= sms \
            and steps >= splits * 2 * MIN_SPLIT_STEPS:
        splits *= 2
    return splits


def split_steps(d: int, splits: int, rank: int) -> range:
    """The k steps (64 deep) of CTA ``rank`` of a tile's cluster."""
    steps = -(-d // BK)
    return range(rank * steps // splits, (rank + 1) * steps // splits)


def block_product(x, router, m0: int, tma: bool, steps=None):
    """The fp32 accumulator [64, N] one block's k steps build (all of D's,
    or ``steps``)."""
    d, e = router.shape
    n = width(e)
    stage = X_STAGE + slice_bytes(n)
    rb = row_bytes(n)
    smem = np.full(stage // 2, np.nan)
    smem[X_STAGE // 2:] = 0.0                     # zeroed once
    acc = np.zeros((BM, n))
    for kb in range(-(-d // BK)) if steps is None else steps:
        tma_box(smem, 2, 0, x, kb * BK, m0, BK, BM, True)
        stage_router(smem, X_STAGE, router, kb * BK, n, tma)
        for kk in range(BK // 16):
            a = read_kmajor(smem, 2, kk * 32, BM, 16)             # [64, 16]
            b = read_nmajor(smem, 2, X_STAGE + kk * 16 * rb, n, 16, rb,
                            lbo=RBLOCK, sbo=8 * rb)               # [N, 16]
            acc += a @ b.T
    return acc


# ---------------------------------------------------------------------------
# the epilogue on the accumulator's registers
# ---------------------------------------------------------------------------

def registers(acc):
    """regs[t, i]: register i of thread t of the m64nN accumulator."""
    n = acc.shape[1]
    regs = np.zeros((THREADS, n // 2))
    for t in range(THREADS):
        for i in range(n // 2):
            r, c = acc_pos(t, i)
            regs[t, i] = acc[r, c]
    return regs


def quad_butterfly(vals, op):
    """vals [128]: each thread's own value -> each thread's after the two
    xor shuffles (1, then 2) of csrc/topk_gating.cu."""
    t = np.arange(THREADS)
    for off in (1, 2):
        vals = op(vals, vals[t ^ off])
    return vals


def epilogue(regs, e: int, k: int, value_only: bool = False):
    """The kernel's epilogue on the registers -> (idx [64, k], w [64, k],
    probs [64, E]) of the block's 64 rows, float32 throughout.
    ``value_only``: the counter-case quad arg-max that compares values
    alone."""
    n = regs.shape[1] * 2
    f32 = np.float32
    t = np.arange(THREADS)
    lane, warp, q = t & 31, t >> 5, t & 3
    idx = np.zeros((BM, k), np.int32)
    w = np.zeros((BM, k), f32)
    probs = np.zeros((BM, e), f32)
    for h in range(2):
        rows = 16 * warp + (lane >> 2) + 8 * h
        # P(j, c), slot 2j + c: register 4j + 2h + c, column 8j + 2q + c
        jj = np.arange(n // 4)
        cols = 8 * (jj // 2)[None, :] + 2 * q[:, None] + (jj % 2)[None, :]
        regi = 4 * (jj // 2) + 2 * h + jj % 2
        real = cols < e
        p = np.where(real, bf16(regs[:, regi]), -np.inf).astype(f32)
        m = quad_butterfly(p.max(1), np.maximum)
        p = np.exp((p - m[:, None]).astype(f32)).astype(f32)
        s = np.zeros(THREADS, f32)
        for j in range(p.shape[1]):                    # in register order
            s = (s + p[:, j]).astype(f32)
        s = quad_butterfly(s, lambda a, b: (a + b).astype(f32))
        p = (p * (f32(1) / s)[:, None]).astype(f32)   # one reciprocal
        for tt in range(THREADS):
            for j in range(p.shape[1]):
                if real[tt, j]:
                    probs[rows[tt], cols[tt, j]] = p[tt, j]
        p = np.where(real, p, -np.inf).astype(f32)
        ws, ids = [], []
        for _ in range(k):
            # a thread's first max in ascending column order
            j = np.argmax(p, axis=1)
            bv, bi = p[t, j], cols[t, j].astype(np.int64)
            bi = np.where(np.isneginf(bv), 2 ** 31 - 1, bi)
            for off in (1, 2):
                ov, oi = bv[t ^ off], bi[t ^ off]
                take = ov > bv if value_only else \
                    (ov > bv) | ((ov == bv) & (oi < bi))
                bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
            p = np.where(cols == bi[:, None], f32(-1), p)
            ws.append(bv)
            ids.append(bi)
        tot = np.zeros(THREADS, f32)
        for v in ws:
            tot = (tot + v).astype(f32)
        for tt in range(THREADS):          # thread q writes choice q
            if q[tt] < k:
                idx[rows[tt], q[tt]] = ids[q[tt]][tt]
                w[rows[tt], q[tt]] = ws[q[tt]][tt] / max(tot[tt], f32(1e-9))
    return idx, w, probs


def model_gating(x, router, k, tma=None, value_only=False, splits=None):
    """The whole kernel: every tile's product (over the CTAs of its
    cluster, their sums added in rank order) and epilogue, rows past T
    never stored."""
    (t, d), e = x.shape, router.shape[1]
    tma = e % 8 == 0 if tma is None else tma
    splits = choose_splits(t, d, e) if splits is None else splits
    out = (np.zeros((t, k), np.int32), np.zeros((t, k), np.float32),
           np.zeros((t, e), np.float32))
    for m0 in range(0, t, BM):
        acc = block_product(x, router, m0, tma, split_steps(d, splits, 0))
        for rank in range(1, splits):
            acc = acc + block_product(x, router, m0, tma,
                                      split_steps(d, splits, rank))
        got = epilogue(registers(acc), e, k, value_only)
        rows = min(BM, t - m0)
        for o, g in zip(out, got):
            o[m0:m0 + rows] = g[:rows]
    return out


def exact_inputs(t, d, e, seed, ties=False):
    """x in quarters, the router in 64ths: exact sums in float32.  Rows 3,
    4 (mod 7) one-hot at column 0 scaled by 16, where the router's row 0
    spaces the logits 128 apart: all but one probability underflow to 0.
    ``ties``: router columns duplicated in pairs, some rows zero."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-4, 5, (t, d)) / 4.0
    router = rng.randint(-8, 9, (d, e)) / 64.0
    if ties:
        router[:, 1::2] = router[:, 0:e - e % 2:2]
        x[::5] = 0.0
    x[:, 0] = 0.0
    router[0] = (np.arange(e) - e // 2) * 8.0
    under = np.arange(t) % 7 >= 3
    under &= np.arange(t) % 7 <= 4
    x[under] = 0.0
    x[under, 0] = 16.0
    return x.astype(np.float32), router.astype(np.float32)


def plain(x, router, k):
    logits = torch.from_numpy(x).bfloat16() @ torch.from_numpy(router) \
        .bfloat16()
    return [a.numpy() for a in ref.ref_topk_gating(logits, k)]


def held(got, want, k):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [3, 8, 16, 128])
def test_model_matches_plain_and_pallas(e, k):
    t, d = 100, 200                     # two blocks, the second ragged
    x, router = exact_inputs(t, d, e, seed=e * 10 + k, ties=e > 3)
    got = model_gating(x, router, k)
    want = plain(x, router, k)
    held(got, want, k)
    kern = j_gating(jnp.asarray(x, jnp.bfloat16), k,
                    router=jnp.asarray(router, jnp.bfloat16), block_t=32,
                    interpret=True)
    held(got, [np.asarray(a) for a in kern], k)
    # the underflowed rows: one probability 1, the rest 0; the second
    # choice the lowest real column not taken, never a padded one
    under = np.arange(t) % 7 == 3
    assert np.all(got[2][under].max(1) == 1.0)
    assert np.all(got[0] < e)
    if k == 2:
        first = got[0][under, 0]
        np.testing.assert_array_equal(got[0][under, 1],
                                      np.where(first == 0, 1, 0))


@pytest.mark.parametrize("e,k", [(40, 2), (256, 1)])
def test_model_matches_plain_at_other_widths(e, k):
    x, router = exact_inputs(70, 72, e, seed=e, ties=True)
    held(model_gating(x, router, k), plain(x, router, k), k)


@pytest.mark.parametrize("e,k", [(16, 2), (128, 1)])
def test_model_split_over_a_cluster_matches_plain(e, k):
    """A tile's k steps split over 4 CTAs, their sums added in rank
    order."""
    x, router = exact_inputs(70, 320, e, seed=e + 1, ties=True)
    held(model_gating(x, router, k, splits=4), plain(x, router, k), k)


def test_splits_cover_each_step_once():
    """The cluster split: 1 CTA a tile at the training shape (128 tiles
    fill the card) and at gpt2-moe's serve prefill (12 steps), 4 at
    mixtral's and llama4's 2048 tokens, 2 at mixtral's 4096, none at E
    256; the ranks' steps cover D's once, each at least MIN_SPLIT_STEPS."""
    assert (MAX_SPLITS, MIN_SPLIT_STEPS) == (8, 16)
    for (t, d, e), want in {(8192, 768, 16): 1, (256, 768, 16): 1,
                            (8, 768, 16): 1, (2048, 6144, 8): 4,
                            (4096, 6144, 8): 2, (2048, 5120, 128): 4,
                            (1000, 5120, 128): 4, (64, 8192, 16): 8,
                            (2048, 5120, 256): 1}.items():
        splits = choose_splits(t, d, e)
        assert splits == want, (t, d, e, splits)
        seen = [kb for r in range(splits) for kb in split_steps(d, splits, r)]
        assert seen == list(range(-(-d // BK)))
        assert all(len(split_steps(d, splits, r)) >= MIN_SPLIT_STEPS
                   for r in range(splits)) or splits == 1


def test_staged_router_equals_tma_router():
    """E % 8 == 0 takes the TMA path; the threads' staging of the same
    router fills the stage identically."""
    x, router = exact_inputs(64, 136, 16, seed=5)
    for m0 in (0,):
        np.testing.assert_array_equal(block_product(x, router, m0, True),
                                      block_product(x, router, m0, False))


def test_value_only_quad_argmax_takes_the_wrong_expert_on_a_tie():
    """The counter-case: an exact tie between columns 1 (thread q 0) and 2
    (q 1) of a quad.  Compared on values alone, each thread keeps its own
    column and masks it, so thread 1 reports column 3 as the second
    choice where the first-max order gives 2."""
    t, d, e = 64, 64, 8
    x = np.zeros((t, d), np.float32)
    x[:, 1] = 1.0
    router = np.zeros((d, e), np.float32)
    router[1] = [0, 1, 1, 0, 0, 0, 0, 0]
    want = plain(x, router, 2)
    np.testing.assert_array_equal(want[0], np.tile([[1, 2]], (t, 1)))
    held(model_gating(x, router, 2), want, 2)
    bad = model_gating(x, router, 2, value_only=True)
    np.testing.assert_array_equal(bad[0], np.tile([[1, 3]], (t, 1)))


def test_span_swizzle_at_128_bytes_is_the_shared_model():
    """The 128-byte case of the span-generic swizzle, box and N-major read
    is ``_tma_model``'s, which the repo's other kernels hold on the card."""
    rng = np.random.RandomState(0)
    glob = rng.randn(70, 100)
    a, b = np.zeros(4096), np.zeros(4096)
    tma_box(a, 2, 0, glob, 64, 8, 64, 64, True)
    tma_box_span(b, 2, 0, glob, 64, 8, 64, 64)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        read_mnmajor(a, 2, 2048, 64, 16, lbo=8192),
        read_nmajor(a, 2, 2048, 64, 16, 128, lbo=8192, sbo=1024))


def test_accumulator_registers_partition_the_tile():
    """Each (row, column) of an m64n64 tile is one register of one thread;
    a thread's two rows are 8 apart, and a quad holds a row's columns."""
    seen = {}
    for t in range(THREADS):
        for i in range(32):
            r, c = acc_pos(t, i)
            assert (r, c) not in seen
            seen[(r, c)] = t
            assert r == 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1)
    assert len(seen) == 64 * 64
    for r in range(64):
        assert len({seen[(r, c)] for c in range(64)}) == 4


# ---------------------------------------------------------------------------
# combine_rows: 16-byte vectors, the choices' loads together
# ---------------------------------------------------------------------------

TOK_WARPS = constant("kTokWarps", DISPATCH)
VEC, CHOICES = constant("kVec", DISPATCH), constant("kChoices", DISPATCH)


def model_combine(buf, rows, w):
    """csrc/dispatch.cu::combine_kernel: warp t % TOK_WARPS of block
    t // TOK_WARPS owns token t; lane l moves vectors l, l + 32, ... of 8
    bf16, loading VEC vectors of CHOICES choices before adding any, in
    choice order, each product and sum rounded to float32; a dropped choice
    adds nothing.  Returns (out, the vectors each (token, lane) stored, the
    loads each (token, lane) had in flight at once)."""
    n_rows, d = buf.shape
    n_tok, k = rows.shape
    dv = d // 8
    f32 = np.float32
    out = np.full((n_tok, d), np.nan, np.float32)
    stored, flight = {}, {}
    for t in range(n_tok):
        for lane in range(32):
            seq, most = [], 0
            for c0 in range(lane, dv, 32 * VEC):
                vs = [c0 + 32 * u for u in range(VEC) if c0 + 32 * u < dv]
                acc = {c: np.zeros(8, f32) for c in vs}
                for j0 in range(0, k, CHOICES):
                    js = [j for j in range(j0, min(j0 + CHOICES, k))
                          if 0 <= rows[t, j] < n_rows]
                    loads = {(c, j): buf[rows[t, j], 8 * c:8 * c + 8]
                             for c in vs for j in js}
                    most = max(most, len(loads))
                    for c in vs:
                        for j in js:           # in choice order
                            acc[c] = (acc[c] + (loads[(c, j)] * f32(
                                w[t, j])).astype(f32)).astype(f32)
                for c in vs:
                    out[t, 8 * c:8 * c + 8] = bf16(acc[c])
                    seq.append(c)
            stored[(t, lane)], flight[(t, lane)] = seq, most
    return out, stored, flight


@pytest.mark.parametrize("d", [768, 776, 64, 8])
def test_combine_vectors_cover_each_row_once(d):
    rng = np.random.RandomState(d)
    n_rows, n_tok, k = 9, 6, 3
    buf = bf16(rng.randn(n_rows, d))
    rows = np.array([[2, -1, 0], [4, 4, 8], [-1, -1, -1], [1, 3, 5],
                     [7, -1, 6], [0, 1, 2]], np.int32)  # -1: dropped
    w = rng.rand(n_tok, k).astype(np.float32)
    got, stored, flight = model_combine(buf, rows, w)
    want = ref.ref_combine_rows(torch.from_numpy(buf).bfloat16(),
                                torch.from_numpy(rows),
                                torch.from_numpy(w)).float().numpy()
    # float32 sums in choice order against the plain version's sum: within
    # one bf16 ulp (the check phase 1 holds the kernel to)
    ulp = np.where(want != 0, 2.0 ** (np.floor(np.log2(np.abs(
        np.where(want != 0, want, 1.0)))) - 7), 2.0 ** -133)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.all(got[2] == 0.0)                 # every choice dropped
    dv = d // 8
    for t in range(n_tok):
        vecs = sorted(c for lane in range(32) for c in stored[(t, lane)])
        assert vecs == list(range(dv))             # the last vector too
        for lane in range(32):
            assert stored[(t, lane)] == list(range(lane, dv, 32))
    # at D 768 and top-2 a lane has all six loads in flight at once
    top2 = model_combine(bf16(rng.randn(4, 768)),
                         np.array([[0, 3], [1, 2]], np.int32),
                         np.ones((2, 2), np.float32))[2]
    assert all(n == 6 for n in top2.values())
    assert TOK_WARPS * 32 <= 1024
