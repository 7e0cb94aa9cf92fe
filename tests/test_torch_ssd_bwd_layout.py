"""``ssd_scan_bwd``'s Hopper kernels (``csrc/ssd_bwd.cu``), the parts the
CPU can reach: numpy models of their index arithmetic and of their
arithmetic.

- The shared-memory plans of the chunk and gradient kernels (two gradient
  blocks an SM), the grids (every (b, chunk, head) once; the state
  kernel's float4 threads over every (b, h, p, n) once; the chunk states
  chunk-major, so that one chunk's slabs are one contiguous stretch).
- The fragments: ``ldmatrix`` (and ``.trans``) at the lane addresses of
  ``lda`` / ``lda_t`` / ``ldb`` / ``ldb_t`` against mma.sync m16n8k16's A
  and B fragments, each 8-lane phase on 8 distinct bank quads through the
  144-byte rows; an accumulator pair as the A fragment of the next
  product (``acc_to_a``).
- The kernels' arithmetic modelled whole: the chunk kernel's state and
  cotangent contributions, the state kernel's two scans, the gradient
  kernel's two orientations (rows t: DX, W, dS, dC; rows s: DX^T, M^T,
  dS^T, dx, G B^T, x G, dB), warp 0's dL, its reverse sum and ddt, the
  sums over head groups and (b, chunk); bf16 hi / lo pairs where the
  kernel splits, float32 elsewhere, L as a float pair with the warp's scan
  order.  Held against ``ref_ssd_bwd`` norm-wise within 1e-4 (the limit
  ``chip_smoke.py`` holds the kernel to on the card) at a ragged T, over
  two head groups, from h0 with a final-state cotangent, at A = 16 and
  under a strong decay (dt a ~ -100 a step, where e^{L_t - L_s}
  overflows above the diagonal).  The counter-case: M^T rounded once to
  bf16 misses 1e-4 in dx.

The models read the kernels' constants (Q, P, N, kWarps, kThreads, kHeads,
kRowF, kSplit, kSmemMax; kRow from ``csrc/warp_mma.cuh``) from the
sources, so a change to the tiling runs through them; the kernels run only
on the card (``chip_smoke.py`` phase 1).
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ref_ssd_bwd
from repro_torch.kernels.ssd import BWD_CHUNK, BWD_HEADS

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SOURCE = (CSRC / "ssd_bwd.cu").read_text()
HEADER = (CSRC / "warp_mma.cuh").read_text()     # kRow, the fragments


def source_constant(name: str) -> int:
    """The value a ``constexpr int`` of ssd_bwd.cu or warp_mma.cuh is set
    to."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                       SOURCE + HEADER)
    assert len(found) == 1, f"ssd_bwd.cu sets {name} {len(found)}x"
    return int(found[0].split("//")[0].strip())


Q = source_constant("Q")                    # steps a chunk
P = source_constant("P")                    # head size
N = source_constant("N")                    # state size
WARPS = source_constant("kWarps")           # a warp a 16-row slab
THREADS = source_constant("kThreads")
HEADS = source_constant("kHeads")           # heads a block
ROW = source_constant("kRow")               # bf16 elements a tile row
ROWF = source_constant("kRowF")             # floats a row of S
SPLIT = source_constant("kSplit")           # bf16 terms of a pair
SMEM_MAX = source_constant("kSmemMax")      # a block's dynamic limit
SM_SMEM = 233472                            # an H100 SM's shared memory
BLOCK_RESERVED = 1024                       # the driver's share a block
REL = 1e-4                                  # chip_smoke.py's REC_REL
f32 = np.float32


def test_the_wrapper_allocates_for_the_kernels_tiling():
    """ssd.py's BWD_CHUNK / BWD_HEADS size the scratch the kernels index."""
    assert (BWD_CHUNK, BWD_HEADS) == (Q, HEADS)
    assert WARPS * 16 == Q == P == N and THREADS == 32 * WARPS


# ---------------------------------------------------------------------------
# shared memory and grids
# ---------------------------------------------------------------------------

TILE = Q * ROW * 2                          # a 64-row bf16 tile, bytes
STEPS = 6 * Q * 4                           # d, L hi, L lo, e^L, ecw, sig


def smem_plans():
    """Byte offsets of ChunkSmem and GradSmem (the structs' member order)
    and their sizes."""
    chunk, off = {}, 0
    for name, size in (("b", TILE), ("c", TILE), ("cwx", SPLIT * TILE),
                       ("edy", SPLIT * TILE), ("st", STEPS)):
        chunk[name], off = off, off + size
    chunk["bytes"] = off
    grad, off = {}, 0
    for name, size in (("b", TILE), ("c", TILE), ("x", TILE),
                       ("dy", SPLIT * TILE), ("hin", SPLIT * TILE),
                       ("gx", SPLIT * TILE), ("s", Q * ROWF * 4),
                       ("colp", WARPS * Q * 4), ("per_step", 5 * Q * 4),
                       ("red", 2 * THREADS * 4), ("st", STEPS)):
        grad[name], off = off, off + size
    grad["bytes"] = off
    return chunk, grad


def test_shared_memory_plans_fit_two_gradient_blocks_an_sm():
    """Both plans fit a block's limit; two gradient blocks (the launch
    bound's 2, 255 registers a thread at most) fit an SM's shared memory;
    every tile starts 16-byte aligned, as ldmatrix and the 16-byte stores
    of the loads need, and a tile row is a whole number of 16-byte
    units."""
    chunk, grad = smem_plans()
    assert chunk["bytes"] <= SMEM_MAX and grad["bytes"] <= SMEM_MAX
    assert 2 * (grad["bytes"] + BLOCK_RESERVED) <= SM_SMEM
    assert "__launch_bounds__(kThreads, 2)" in SOURCE
    assert (ROW * 2) % 16 == 0 and (ROWF * 4) % 8 == 0
    for plan in (chunk, grad):
        for name, off in plan.items():
            assert off % 16 == 0, name


def test_grids_cover_every_chunk_head_and_state_element_once():
    """Chunk and gradient kernels: grid (chunks, groups, B), a block the
    heads [g kHeads, min(H, (g + 1) kHeads)); the state kernel: a thread a
    float4 of the B H P N slab; the chunk-state slab of (c, kind, b, h) is
    chunk-major."""
    for bsz, t, h in ((4, 2048, 64), (1, 130, 3), (2, 64, 10)):
        chunks, groups = -(-t // Q), -(-h // HEADS)
        seen = [(b, c, hh) for c, g, b in itertools.product(
            range(chunks), range(groups), range(bsz))
            for hh in range(g * HEADS, min(h, (g + 1) * HEADS))]
        assert sorted(seen) == list(itertools.product(range(bsz),
                                                      range(chunks),
                                                      range(h)))
        slab4 = bsz * h * P * N // 4
        firsts = sorted(4 * i for i in range(slab4))
        assert firsts == list(range(0, bsz * h * P * N, 4))

        def slab(c, kind, b, hh):
            return (((2 * c + kind) * bsz + b) * h + hh) * P * N
        starts = sorted(slab(c, k, b, hh) for c, k, b, hh in itertools.product(
            range(chunks), range(2), range(bsz), range(h)))
        assert starts == list(range(0, chunks * 2 * bsz * h * P * N, P * N))
        assert slab(1, 0, 0, 0) - slab(0, 1, 0, 0) == bsz * h * P * N


# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------

def ldmatrix(tile, addrs, trans):
    """ldmatrix .x4 of b16 elements: addrs[lane] is the element offset of
    row lane % 8 of matrix lane // 8; returns regs[lane][j] = (low, high)
    values of matrix j."""
    out = np.zeros((32, 4, 2), tile.dtype)
    for t, j in itertools.product(range(32), range(4)):
        rows = [addrs[8 * j + r] for r in range(8)]
        if trans:
            out[t, j] = (tile[rows[2 * (t % 4)] + t // 4],
                         tile[rows[2 * (t % 4) + 1] + t // 4])
        else:
            out[t, j] = tile[rows[t // 4] + 2 * (t % 4)
                             + np.arange(2)]
    return out


def lane_addr(kind, lane, m0, k0):
    """The kernel's address of a lane for lda / lda_t / ldb / ldb_t."""
    j, r = lane >> 3, lane & 7
    if kind == "lda":
        return (m0 + (j & 1) * 8 + r) * ROW + k0 + (j >> 1) * 8
    if kind == "lda_t":
        return (k0 + (j >> 1) * 8 + r) * ROW + m0 + (j & 1) * 8
    if kind == "ldb":
        return (m0 + (j >> 1) * 8 + r) * ROW + k0 + (j & 1) * 8
    return (k0 + (j & 1) * 8 + r) * ROW + m0 + (j >> 1) * 8


def a_frag(t, reg):
    """mma.m16n8k16's A fragment: (row, k) pairs of register reg of lane t."""
    g, q = t >> 2, t & 3
    return [(g + 8 * (reg & 1), 2 * q + 8 * (reg >> 1) + e) for e in (0, 1)]


def b_frag(t, reg):
    """The B fragments of two n8 tiles (ldb's r[0..1], r[2..3]): (k, n)."""
    g, q = t >> 2, t & 3
    return [(2 * q + 8 * (reg & 1) + e, g + 8 * (reg >> 1)) for e in (0, 1)]


@pytest.mark.parametrize("kind", ["lda", "lda_t", "ldb", "ldb_t"])
def test_ldmatrix_addresses_give_the_mma_fragments(kind):
    """Every lane gets the (row, k) / (k, column) elements mma.sync expects,
    from a tile stored [m][k] (lda), [k][m] (lda_t), [n][k] (ldb) or [k][n]
    (ldb_t), at every 16-row / 16-k offset of a 64 x 64 tile."""
    tile = np.arange(Q * ROW, dtype=np.int64)      # the element's offset
    for m0, k0 in itertools.product(range(0, 64, 16), repeat=2):
        addrs = [lane_addr(kind, lane, m0, k0) for lane in range(32)]
        got = ldmatrix(tile, addrs, kind.endswith("_t"))
        for t, reg in itertools.product(range(32), range(4)):
            pos = a_frag(t, reg) if kind.startswith("lda") else b_frag(t, reg)
            for e, (u, w) in enumerate(pos):
                row, col = (m0 + u, k0 + w) if kind == "lda" else \
                    (k0 + w, m0 + u) if kind == "lda_t" else \
                    (m0 + w, k0 + u) if kind == "ldb" else (k0 + u, m0 + w)
                assert got[t, reg, e] == row * ROW + col, (kind, t, reg)


@pytest.mark.parametrize("kind", ["lda", "lda_t", "ldb", "ldb_t"])
def test_ldmatrix_phases_hit_distinct_banks(kind):
    """Each 8-lane phase reads 8 rows of 16 bytes; the 144-byte rows put
    them on 8 distinct quads of the 32 banks (no conflict)."""
    for m0, k0 in itertools.product(range(0, 64, 16), repeat=2):
        for phase in range(4):
            quads = {(lane_addr(kind, lane, m0, k0) * 2 // 16) % 8
                     for lane in range(8 * phase, 8 * phase + 8)}
            assert len(quads) == 8


def test_accumulator_pair_is_the_next_a_fragment():
    """acc_to_a: accumulator tiles 2kk, 2kk + 1 (rows g, g + 8; columns
    8 j + 2 q + e) land where the A fragment of k16 step kk expects them."""
    for t, kk in itertools.product(range(32), range(4)):
        g, q = t >> 2, t & 3
        regs = [(2 * kk, 0), (2 * kk, 2), (2 * kk + 1, 0), (2 * kk + 1, 2)]
        for reg, (j, i) in enumerate(regs):
            for e in (0, 1):
                acc = (g + 8 * (i >> 1), 8 * j + 2 * q + e)
                row, k = a_frag(t, reg)[e]
                assert acc == (row, 16 * kk + k)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def bf16(a):
    """Round float32 to bf16 (nearest, ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def split(v, lo=True):
    """split2: hi = bf16(v), lo = bf16(v - hi) (lo zero: one rounding)."""
    v = np.asarray(v, np.float32)
    hi = bf16(v)
    return hi, bf16(v - hi) if lo else np.zeros_like(hi)


def mm(*pairs):
    """A sum of products with float32 sums (exact products of the bf16
    terms, summed in float64 and rounded once)."""
    acc = 0.0
    for a, b in pairs:
        acc = acc + a.astype(np.float64) @ b.astype(np.float64)
    return np.asarray(acc, np.float32)


def softplus(v):
    v = v.astype(f32)
    return np.where(v > 20, v, np.log1p(np.exp(v))).astype(f32)


def pair_add(ah, al, bh, bl):
    """The kernel's pair_add: two_sum of the highs, the lows and the error
    added, renormalised."""
    s = (ah + bh).astype(f32)
    bb = (s - ah).astype(f32)
    e = ((ah - (s - bb)).astype(f32) + (bh - bb).astype(f32)).astype(f32)
    lo = ((al + bl).astype(f32) + e).astype(f32)
    hi = (s + lo).astype(f32)
    return hi, (lo - (hi - s)).astype(f32)


def lane_scan(v, add):
    """The warp's shuffle-up scan of 32 lane values (Hillis-Steele)."""
    v = list(v)
    off = 1
    while off < 32:
        v = [add(v[i], v[i - off]) if i >= off else v[i] for i in range(32)]
        off *= 2
    return v


def chunk_steps(raw, nv, a):
    """chunk_steps: d (0 past T, after the softplus), L as a float pair by
    the warp's scan (lane l: steps 2l, 2l + 1), the rows past T at L of the
    last row below T, e^L, e^{L_Q - L}, sigmoid(dt)."""
    idx = np.arange(Q)
    d = np.where(idx < nv, softplus(raw), f32(0)).astype(f32)
    ell = (d * a).astype(f32)
    z = f32(0)
    pairs = [pair_add(ell[2 * i], z, ell[2 * i + 1], z) for i in range(32)]
    incl = lane_scan(pairs, lambda x, y: pair_add(x[0], x[1], y[0], y[1]))
    excl = [(z, z)] + incl[:-1]
    lh, ll = np.zeros(Q, f32), np.zeros(Q, f32)
    for i in range(32):
        lh[2 * i], ll[2 * i] = pair_add(*excl[i], ell[2 * i], z)
        lh[2 * i + 1], ll[2 * i + 1] = pair_add(lh[2 * i], ll[2 * i],
                                                ell[2 * i + 1], z)
    lh[idx >= nv], ll[idx >= nv] = lh[nv - 1], ll[nv - 1]
    el = np.exp((lh + ll).astype(f32)).astype(f32)
    ecw = np.exp(((lh[-1] - lh) + (ll[-1] - ll)).astype(f32)).astype(f32)
    sig = (1 / (1 + np.exp(-raw))).astype(f32)
    return d, lh, ll, el, ecw, sig


def warp_sums(v, reverse=False, exclusive=False):
    """Warp 0's sums over the 64 steps (lane l: steps 2l, 2l + 1, or 63 -
    2l, 62 - 2l reversed): a shuffle scan of the lanes' pair sums."""
    r = v[::-1] if reverse else v
    pair = [f32(r[2 * i] + r[2 * i + 1]) for i in range(32)]
    incl = lane_scan(pair, lambda x, y: f32(x + y))
    ex = [f32(0)] + incl[:-1]
    out = np.zeros(Q, f32)
    for i in range(32):
        out[2 * i] = ex[i] if exclusive else f32(ex[i] + r[2 * i])
        out[2 * i + 1] = f32(ex[i] + r[2 * i]) if exclusive else \
            f32(out[2 * i] + r[2 * i + 1])
    return out[::-1] if reverse else out


def model_ssd_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t, m_split=True):
    """The four kernels of ssd_scan_bwd.  ``m_split=False`` rounds M^T once
    to bf16."""
    bsz, t, h, _ = x.shape
    chunks, groups = -(-t // Q), -(-h // HEADS)
    a = (-np.exp(a_log.astype(f32))).astype(f32)
    pad = ((0, 0), (0, chunks * Q - t))
    x, dy = (np.pad(v.astype(f32), pad + ((0, 0), (0, 0))) for v in (x, dy))
    b, c, dt = (np.pad(v.astype(f32), pad + ((0, 0),)) for v in (b, c, dt))
    states = np.zeros((chunks, 2, bsz, h, P, N), f32)
    decay = np.zeros((chunks, bsz, h), f32)
    steps = {}
    # the chunk kernel
    for bb, ci, hh in itertools.product(range(bsz), range(chunks), range(h)):
        nv, sl = min(Q, t - ci * Q), slice(ci * Q, ci * Q + Q)
        st = steps[bb, ci, hh] = chunk_steps(dt[bb, sl, hh], nv, a[hh])
        d, _, _, el, ecw, _ = st
        cwx = split((d * ecw)[:, None] * x[bb, sl, hh])
        states[ci, 0, bb, hh] = mm((cwx[0].T, b[bb, sl]),
                                   (cwx[1].T, b[bb, sl]))
        edy = split(el[:, None] * dy[bb, sl, hh])
        states[ci, 1, bb, hh] = mm((edy[0].T, c[bb, sl]),
                                   (edy[1].T, c[bb, sl]))
        decay[ci, bb, hh] = el[-1]
    # the state kernel: each chunk's slot takes the entering state / the
    # leaving cotangent in place of its contribution
    for kind, start in ((0, h0), (1, dh_t)):
        cur = np.zeros((bsz, h, P, N), f32) if start is None \
            else start.astype(f32)
        order = range(chunks) if kind == 0 else reversed(range(chunks))
        for ci in order:
            cur, states[ci, kind] = (
                decay[ci][..., None, None].astype(np.float64) * cur
                + states[ci, kind]).astype(f32), cur
    dh0 = cur
    # the gradient kernel
    dx = np.zeros((bsz, chunks * Q, h, P), f32)
    ddt = np.zeros((bsz, chunks * Q, h), f32)
    part = np.zeros((bsz, chunks * Q, groups, 2, N), f32)
    scal = np.zeros((bsz, chunks, h, 2), f32)
    below = np.tril(np.ones((Q, Q), bool), -1)            # s < t, [t, s]
    causal = np.tril(np.ones((Q, Q), bool))
    for bb, ci, g in itertools.product(range(bsz), range(chunks),
                                       range(groups)):
        sl = slice(ci * Q, ci * Q + Q)
        bt, ct = b[bb, sl], c[bb, sl]
        s_mat = mm((ct, bt.T))
        dbg, dcg = np.zeros((Q, N), f32), np.zeros((Q, N), f32)
        for hh in range(g * HEADS, min(h, (g + 1) * HEADS)):
            d, lh, ll, el, ecw, sig = steps[bb, ci, hh]
            xs, dys = x[bb, sl, hh], dy[bb, sl, hh]
            hin, gx = states[ci, 0, bb, hh], states[ci, 1, bb, hh]
            dyh, dyl = split(dys)
            hih, hil = split(hin)
            gxh, gxl = split(gx)
            hg = f32((gx.astype(np.float64) * hin).sum())
            ldiff = ((lh[:, None] - lh[None, :]).astype(f32)
                     + (ll[:, None] - ll[None, :]).astype(f32)).astype(f32)
            e = np.where(causal, np.exp(np.where(causal, ldiff, 0)), 0
                         ).astype(f32)
            # rows t
            dxm = mm((dyh, xs.T), (dyl, xs.T))
            w = (s_mat * dxm * e).astype(f32)
            rz = np.where(below, w * d[None, :], 0).sum(1).astype(f32)
            colw = np.where(below, w, 0).sum(0).astype(f32)
            wd = np.diag(w).astype(f32)
            ds = split(np.where(causal, dxm * e * d[None, :], 0))
            dcg = (dcg + mm((ds[0], bt), (ds[1], bt))).astype(f32)
            dcr = mm((dyh, hih), (dyh, hil), (dyl, hih))
            dcs = (el[:, None] * dcr).astype(f32)
            sa = (ct * dcs).sum(1).astype(f32)
            dcg = (dcg + dcs).astype(f32)
            # rows s
            dxt = mm((xs, dyh.T), (xs, dyl.T))
            et = (e.T * d[:, None]).astype(f32)
            dst = split(dxt * et)
            dbg = (dbg + mm((dst[0], ct), (dst[1], ct))).astype(f32)
            mh, ml = split(s_mat.T * et, m_split)
            dxa = mm((mh, dyh), (mh, dyl), (ml, dyh))
            gb = mm((bt, gxh.T), (bt, gxl.T))
            cw = (d * ecw).astype(f32)
            dyp = (dyh + dyl).astype(f32)     # dy as its pair
            dx[bb, sl, hh] = d_skip[hh] * dyp + dxa + cw[:, None] * gb
            v = (ecw * (xs * gb).sum(1)).astype(f32)
            xg = mm((xs, gxh), (xs, gxl))
            dbg = (dbg + cw[:, None] * xg).astype(f32)
            # warp 0
            dl = (rz - d * colw + sa).astype(f32)
            dl[-1] += el[-1] * hg
            up = warp_sums((d * v).astype(f32), exclusive=True)
            ell = (warp_sums(dl, reverse=True) + up).astype(f32)
            ddt[bb, sl, hh] = (colw + wd + v + a[hh] * ell) * sig
            scal[bb, ci, hh] = ((d * ell).sum(), (dyp * xs).sum())
        part[bb, sl, g, 0], part[bb, sl, g, 1] = dbg, dcg
    # the sum kernel, in order
    db = part[:, :t, :, 0].sum(2, dtype=f32)
    dc = part[:, :t, :, 1].sum(2, dtype=f32)
    da_log = (a * scal[..., 0].sum((0, 1), dtype=f32)).astype(f32)
    dd = scal[..., 1].sum((0, 1), dtype=f32)
    return dx[:, :t], ddt[:, :t], da_log, db, dc, dd, dh0


CASES = {  # name: (B, T, H, dt scale, dt shift, A of every head, h0 / dh_T)
    "ragged": (2, 300, 3, 1.0, 0.0, None, False),
    "two groups": (1, 130, HEADS + 2, 1.0, 0.0, None, True),
    "h0 A=16": (1, 256, 2, 1.0, 0.0, 16.0, True),
    # softplus(dt) ~ 6.25: dt a ~ -100 a step at a = -16, e^{L_t - L_s}
    # overflows above the diagonal
    "strong decay": (1, 200, 2, 0.2, 6.25, None, True),
}


def case_inputs(name):
    bsz, t, h, scale, shift, a_top, states = CASES[name]
    rng = np.random.RandomState(len(name))
    x = bf16(rng.randn(bsz, t, h, P).astype(f32))
    b = bf16(rng.randn(bsz, t, N).astype(f32))
    c = bf16(rng.randn(bsz, t, N).astype(f32))
    dt = bf16(rng.randn(bsz, t, h).astype(f32) * scale + shift)
    a_log = (np.log(np.linspace(1.0, 16.0, h)) if a_top is None
             else np.full(h, np.log(a_top))).astype(f32)
    d_skip = np.ones(h, f32)
    h0 = rng.randn(bsz, h, P, N).astype(f32) if states else None
    dh_t = rng.randn(bsz, h, P, N).astype(f32) if states else None
    dy = rng.randn(bsz, t, h, P).astype(f32)
    return x, dt, a_log, b, c, d_skip, h0, dy, dh_t


def reference(args):
    return ref_ssd_bwd(*(None if v is None else torch.tensor(v)
                         for v in args))


def rel(got, want):
    want = want.numpy().astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_ref_ssd_bwd(name):
    args = case_inputs(name)
    got = model_ssd_bwd(*args)
    want = reference(args)
    errs = {n: rel(g, w) for n, g, w in zip(NAMES, got, want)}
    assert all(np.isfinite(g).all() for g in got)
    assert max(errs.values()) <= REL, errs


def test_one_bf16_rounding_of_m_misses_the_limit():
    """The counter-case: M^T without its lo term misses 1e-4 in dx."""
    args = case_inputs("ragged")
    got = model_ssd_bwd(*args, m_split=False)
    assert rel(got[0], reference(args)[0]) > REL


def test_padded_rows_take_no_decay():
    """A zero-filled dt row is softplus(0) = ln 2, not 0: the kernel masks
    d after the softplus, and the rows past T take L of the last row below
    T exactly, so e^{L_Q - L_s} and e^{L_Q} are those of the last row."""
    raw = np.zeros(Q, f32)
    d, lh, ll, el, ecw, _ = chunk_steps(raw, 44, f32(-16.0))
    assert (d[44:] == 0).all() and (lh[44:] == lh[43]).all()
    assert (ll[44:] == ll[43]).all() and el[-1] == el[43]
    assert ecw[43] == 1.0
    d2, lh2, _, _, _, _ = chunk_steps(raw, Q, f32(-16.0))
    assert np.isclose(d2[50], np.log(2)) and lh2[-1] < lh[-1]


def test_the_float_pair_keeps_l_exact():
    """At |L| ~ 6e3 (dt a ~ -100 a step over a chunk) the pair's L_t - L_s
    matches float64 to ~1e-12 relative of |L|, where one float32 sum is
    off by ~1e-4 absolute: 1e-4 relative in e^{L_t - L_s} of near steps."""
    rng = np.random.RandomState(3)
    ell = (-100 + rng.randn(Q)).astype(f32)
    z = f32(0)
    pairs = [pair_add(ell[2 * i], z, ell[2 * i + 1], z) for i in range(32)]
    incl = lane_scan(pairs, lambda x, y: pair_add(x[0], x[1], y[0], y[1]))
    exact = np.cumsum(ell.astype(np.float64))
    got = np.array([incl[i][0] + np.float64(incl[i][1]) for i in range(32)])
    assert np.abs(got - exact[1::2]).max() <= 1e-9 * np.abs(exact).max()
    single = np.cumsum(ell, dtype=f32)
    assert np.abs(single - exact).max() > 1e-5


# ---------------------------------------------------------------------------
# the chunk-state scan both backwards share, and the wrapper's fp32 operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 64])
def test_the_shared_state_scan_reads_each_slabs_decay(rows):
    """warp_mma.cuh's chunk_state_kernel<kDecayRows>: thread n (a float4 of
    the B H slabs of 64 x 64) reads decay n / (1024 / kDecayRows) of a
    chunk, chunks bh kDecayRows apart: SSD's decay of its (b, h) (1) and
    WKV's of its state row (64); each backward launches its instance."""
    assert "decay + n / (64 * 64 / 4 / kDecayRows)" in HEADER
    assert "const long long dstride = bh * kDecayRows;" in HEADER
    assert "chunk_state_kernel<1><<<" in SOURCE
    wkv = (CSRC / "rwkv6_bwd.cu").read_text()
    assert "chunk_state_kernel<HD><<<" in wkv
    assert "state_kernel(const Args" not in SOURCE + wkv
    bh = 6
    n = np.arange(bh * 64 * 64 // 4)
    slab, row = n // 1024, (n % 1024) // 16      # (b, h) and state row
    want = slab if rows == 1 else slab * 64 + row
    assert (n // (64 * 64 // 4 // rows) == want).all()
    for c in range(3):     # [chunks][B H][rows]: chunk c's entry of the same
        assert (c * bh * rows + want < (c + 1) * bh * rows).all()


def fake_card(monkeypatch, module, entry):
    """Run ``module``'s wrapper past its CPU branch with a stand-in library
    that records the arguments of ``entry`` and returns 0."""
    seen = {}

    class Lib:
        def __getattr__(self, name):
            assert name == entry

            def call(*args):
                seen["args"] = [getattr(a, "value", a) for a in args]
                return 0
            return call
    monkeypatch.setattr(module, "on_cpu", lambda *t: False)
    monkeypatch.setattr(module, "lib", lambda name: Lib())
    monkeypatch.setattr(module, "stream", lambda t: None)
    return seen


def misaligned(*shape):
    """A contiguous fp32 tensor whose base is 4 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 4)
    off = (-base.data_ptr() // 4) % 4 + 1
    out = base[off:off + n].view(*shape)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out.normal_()


def test_the_wrapper_copies_a_misaligned_fp32_operand(monkeypatch):
    """dy, h0 and dh_t are loaded in 16-byte vectors: a view whose base is
    not 16-byte aligned reaches the kernels as an aligned copy of the same
    values, not as a misaligned address."""
    from repro_torch.kernels import ssd
    seen = fake_card(monkeypatch, ssd, "ssd_scan_bwd")
    monkeypatch.setattr(ssd.SSD_SCAN_BWD, "count", 0)
    bsz, t, h = 1, 8, 2
    bf = torch.bfloat16
    x = torch.randn(bsz, t, h, P).to(bf)
    dt = torch.randn(bsz, t, h).to(bf)
    b, c = (torch.randn(bsz, t, N).to(bf) for _ in range(2))
    h0, dy, dh_t = misaligned(bsz, h, P, N), misaligned(bsz, t, h, P), \
        misaligned(bsz, h, P, N)
    ssd.ssd_scan_bwd(x, dt, torch.zeros(h), b, c, torch.ones(h), h0, dy,
                     dh_t)
    args = seen["args"]
    for i in (6, 7, 8):                     # h0, dy, dhT
        assert args[i] % 16 == 0
    assert ssd.SSD_SCAN_BWD.count == 1
