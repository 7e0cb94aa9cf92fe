"""``rwkv6_wkv_bwd``'s Hopper kernels (``csrc/rwkv6_bwd.cu``), the parts the
CPU can reach: numpy models of their index arithmetic and of their
arithmetic.

- The shared-memory plans, the grids (a block a (chunk, h, b); thread
  (channel i, sub-chunk a) over every pair once; the walk warps' 16 x 32
  tiles over the 64 x 64 state once; the eight n8 column tiles of the
  sub-chunk products over 64 columns once), the chunk states chunk-major.
- ``ldb1`` / ``ldb1_t`` (ldmatrix .x2) against mma.sync's B fragment of one
  n8 tile; ``row_sums``' butterfly of a row of A over the 32 lanes (every
  lane the same sum).
- The kernels' arithmetic modelled whole: the chunk kernel's decays
  (products of x = e^w within the sub-chunks, the chunk's prefix and
  suffix from the sub-chunks' decays), its state and cotangent
  contributions; the state kernel's scans with a decay a row; the gradient
  kernel's walks (S_a, G_a carried in float32, their bf16 pairs multiplied
  with the sub-chunk's rows), the chains on the CUDA cores (dr, dk, A's
  diagonal blocks, dw's sums and its rectangle from the prefix sums of the
  row terms), dv on the tensor cores; bf16 hi / lo pairs where the kernel
  splits, float32 elsewhere.  Held against ``ref_rwkv6_bwd`` norm-wise
  within 1e-4 (the limit ``chip_smoke.py`` holds the kernel to on the
  card) under the model's decays at a ragged T, under a strong decay (log
  decay -5 to -20 a step) and a weak one (-1e-4) from s0 with a final-state
  cotangent, and at T < 64.  Counter-cases: A rounded once to bf16 misses
  1e-4 in dv; dw as the reverse sum over a chunk of r .* dr - k .* dk (the
  usual chunked form, one level of chains over 64 steps) misses it under
  the strong decay.

The models read the kernels' constants (HD, Q, kSub, kThreads, kRowF,
kSplit, kSmemMax; kRow from ``csrc/warp_mma.cuh``) from the sources; the
kernels run only on the card (``chip_smoke.py`` phase 1).
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ref_rwkv6_bwd
from repro_torch.kernels.rwkv6 import BWD_CHUNK

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SOURCE = (CSRC / "rwkv6_bwd.cu").read_text()
HEADER = (CSRC / "warp_mma.cuh").read_text()


def source_constant(name: str) -> int:
    """The value a ``constexpr int`` of rwkv6_bwd.cu or warp_mma.cuh is set
    to (a product of two constants evaluated)."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);",
                       SOURCE + HEADER)
    assert len(found) == 1, f"rwkv6_bwd.cu sets {name} {len(found)}x"
    expr = found[0].split("//")[0].strip()
    return int(eval(expr, {}, dict(CONSTS)))


CONSTS: dict = {}
for _name in ("HD", "Q", "kSub", "kSubs", "kThreads", "kRow", "kRowF",
              "kSplit", "kSmemMax"):
    CONSTS[_name] = source_constant(_name)
HD, Q, SUB, SUBS = CONSTS["HD"], CONSTS["Q"], CONSTS["kSub"], CONSTS["kSubs"]
THREADS, ROW, ROWF = CONSTS["kThreads"], CONSTS["kRow"], CONSTS["kRowF"]
SPLIT, SMEM_MAX = CONSTS["kSplit"], CONSTS["kSmemMax"]
REL = 1e-4                                  # chip_smoke.py's REC_REL
f32 = np.float32


def test_the_tiling_the_kernels_and_the_wrapper_share():
    """The wrapper sizes the scratch by BWD_CHUNK; a thread a (channel,
    sub-chunk); sub-chunks of one mma row tile; eight warps, the walks'
    4 x 2 tiles of 16 x 32 and the products' 8 column tiles of 8."""
    assert BWD_CHUNK == Q and SUBS * SUB == Q and SUB == 16
    assert THREADS == HD * SUBS == 256 and HD == 64


# ---------------------------------------------------------------------------
# shared memory and grids
# ---------------------------------------------------------------------------

TILE = Q * ROW * 2


def smem_plans():
    """Sizes of ChunkSmem and GradSmem (the structs' members, in order) and
    every member's offset."""
    chunk = (("w", Q * ROWF * 4), ("r", Q * HD * 2), ("k", Q * HD * 2),
             ("v", TILE), ("dy", SPLIT * TILE), ("kd", SPLIT * TILE),
             ("re", SPLIT * TILE), ("gdec", SUBS * HD * 4))
    grad = (("r", Q * HD * 2), ("k", Q * HD * 2), ("v", TILE),
            ("dy", SPLIT * TILE), ("re", SPLIT * TILE), ("kd", SPLIT * TILE),
            ("wt", 2 * SPLIT * TILE), ("t2", Q * ROWF * 4),
            ("t3", Q * ROWF * 4), ("dvs", Q * ROWF * 4),
            ("da", SUBS * SUB * SUB * 4), ("ad", SUBS * 2 * SUB * SUB * 4),
            ("gdec", SUBS * HD * 4), ("rsp", 2 * SUBS * HD * 4),
            ("small", 3 * 64 * 4), ("dup", SUBS * HD * 4))
    out = []
    for plan in (chunk, grad):
        offs, off = {}, 0
        for name, size in plan:
            offs[name], off = off, off + size
        offs["bytes"] = off
        out.append(offs)
    return out


def test_shared_memory_plans_fit_and_align():
    """Both plans fit a block's limit (the gradient kernel one block an SM,
    its 255 registers a thread at 256 threads); every member starts 16-byte
    aligned (ldmatrix rows, the 16-byte stores of the loads, float4 rows of
    the staged w)."""
    chunk, grad = smem_plans()
    assert chunk["bytes"] <= SMEM_MAX and grad["bytes"] <= SMEM_MAX
    assert "__launch_bounds__(kThreads, 1)\nwkv_bwd_grad_kernel" in SOURCE
    assert (ROW * 2) % 16 == 0 and (ROWF * 4) % 16 == 0
    for plan in (chunk, grad):
        for name, off in plan.items():
            assert off % 16 == 0, name


def test_grids_threads_and_tiles_cover_everything_once():
    for bsz, t, h in ((4, 2048, 32), (1, 40, 3)):
        chunks = -(-t // Q)
        blocks = list(itertools.product(range(chunks), range(h), range(bsz)))
        assert len(set(blocks)) == chunks * h * bsz
    pairs = {(tid & (HD - 1), tid >> 6) for tid in range(THREADS)}
    assert pairs == set(itertools.product(range(HD), range(SUBS)))
    # warp w of a thread (i, a) holds channels of one sub-chunk: its A sums
    assert all(len({tid >> 6 for tid in range(32 * w, 32 * w + 32)}) == 1
               for w in range(THREADS // 32))
    cells = np.zeros((HD, HD), int)
    for warp in range(THREADS // 32):
        rg, ch = warp & 3, warp >> 2
        cells[16 * rg:16 * rg + 16, 32 * ch:32 * ch + 32] += 1
    assert (cells == 1).all()
    cols = sorted(c for warp in range(THREADS // 32)
                  for c in range(8 * warp, 8 * warp + 8))
    assert cols == list(range(HD))


# ---------------------------------------------------------------------------
# fragments and the row sums
# ---------------------------------------------------------------------------

def ldmatrix_x2(tile, addrs, trans):
    """ldmatrix .x2: lanes 0-15 give the rows of matrices 0 and 1."""
    out = np.zeros((32, 2, 2), tile.dtype)
    for t, j in itertools.product(range(32), range(2)):
        rows = [addrs[8 * j + r] for r in range(8)]
        if trans:
            out[t, j] = (tile[rows[2 * (t % 4)] + t // 4],
                         tile[rows[2 * (t % 4) + 1] + t // 4])
        else:
            out[t, j] = tile[rows[t // 4] + 2 * (t % 4) + np.arange(2)]
    return out


@pytest.mark.parametrize("trans", [False, True])
def test_ldb1_gives_the_b_fragment_of_one_tile(trans):
    """ldb1 (tile stored [n][k]) / ldb1_t ([k][n]): lane t's b0 holds (k 2q,
    2q + 1; column g), b1 (k 2q + 8, 2q + 9; column g)."""
    tile = np.arange(Q * ROW, dtype=np.int64)
    for n0, k0 in itertools.product(range(0, 64, 8), range(0, 64, 16)):
        addrs = []
        for lane in range(32):
            ln = lane & 15
            addrs.append((k0 + (ln >> 3) * 8 + (ln & 7)) * ROW + n0 if trans
                         else (n0 + (ln & 7)) * ROW + k0 + (ln >> 3) * 8)
        got = ldmatrix_x2(tile, addrs, trans)
        for t, reg, e in itertools.product(range(32), range(2), range(2)):
            k, n = k0 + 2 * (t & 3) + 8 * reg + e, n0 + (t >> 2)
            want = k * ROW + n if trans else n * ROW + k
            assert got[t, reg, e] == want


def row_sums(p, n):
    """row_sums over 32 lanes: p [32, 16] float32, the lanes' entries; an
    xor butterfly an entry (offsets 16 .. 1).  Returns every lane's sums."""
    p = p.astype(f32).copy()
    off = 16
    while off >= 1:
        p[:, :n] = (p[:, :n] + p[np.arange(32) ^ off, :n]).astype(f32)
        off >>= 1
    return p[:, :n]


@pytest.mark.parametrize("n", list(range(1, SUB)))
def test_row_sums_leave_every_lane_the_same_sum(n):
    """Each of a row's n entries of A summed over the warp's channels: every
    lane ends with the same bits (lane 0 writes; nothing depends on which),
    the sum of the 32 lanes' partials to float32 rounding."""
    rng = np.random.RandomState(n)
    p = np.zeros((32, SUB), f32)
    p[:, :n] = rng.randn(32, n)
    got = row_sums(p, n)
    assert (got == got[0]).all()
    assert np.allclose(got[0], p[:, :n].astype(np.float64).sum(0),
                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def bf16(a):
    """Round float32 to bf16 (nearest, ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def split(v, lo=True):
    v = np.asarray(v, np.float32)
    hi = bf16(v)
    return hi, bf16(v - hi) if lo else np.zeros_like(hi)


def mm(*pairs):
    """float32 sums of exact products of the bf16 terms."""
    acc = 0.0
    for a, b in pairs:
        acc = acc + a.astype(np.float64) @ b.astype(np.float64)
    return np.asarray(acc, np.float32)


def sub_decays(x):
    """sub_decays, a sub-chunk at a time: E (x_o .. x_{t-1}), D (x_{s+1}
    .. x_{o+15}), G (the sub-chunk's product), float32 in step order."""
    e = np.ones((Q, HD), f32)
    d = np.ones((Q, HD), f32)
    g = np.zeros((SUBS, HD), f32)
    for a in range(SUBS):
        o = a * SUB
        for t in range(1, SUB):
            e[o + t] = e[o + t - 1] * x[o + t - 1]
        for t in range(SUB - 2, -1, -1):
            d[o + t] = d[o + t + 1] * x[o + t + 1]
        g[a] = e[o + SUB - 1] * x[o + SUB - 1]
    return e, d, g


def chunk_kernel(r, k, v, x, dy):
    """One (chunk, h, b): the state contribution (k DS)^T v, the cotangent
    contribution (r EP)^T dy and the chunk's decay a row."""
    e, d, g = sub_decays(x)
    pre, suf = np.ones((SUBS, HD), f32), np.ones((SUBS, HD), f32)
    for a in range(1, SUBS):
        pre[a] = pre[a - 1] * g[a - 1]
    for a in range(SUBS - 2, -1, -1):
        suf[a] = suf[a + 1] * g[a + 1]
    ep = (np.repeat(pre, SUB, 0) * e).astype(f32)
    ds = (d * np.repeat(suf, SUB, 0)).astype(f32)
    kds, rep, dys = split(k * ds), split(r * ep), split(dy)
    xc = mm((kds[0].T, v), (kds[1].T, v))
    yc = mm((rep[0].T, dys[0]), (rep[0].T, dys[1]), (rep[1].T, dys[0]))
    return xc, yc, (pre[-1] * g[-1]).astype(f32)


def grad_kernel(r, k, v, x, dy, u, s_in, g_out, nv, a_split=True):
    """One (chunk, h, b): dr, dk, dv, dw of its steps and du's partial."""
    e, d, g = sub_decays(x)
    dyh, dyl = split(dy)
    re, kd = split(r * e), split(k * d)
    vd = np.where(np.arange(Q) < nv, (v.astype(np.float64) * dy).sum(1), 0
                  ).astype(f32)
    ruk = (r.astype(np.float64) * u * k).sum(1).astype(f32)
    # the forward walk: S_a, T2 = S_a dy over the sub-chunk, the update
    s, t2, sa = s_in.copy(), np.zeros((Q, HD), f32), []
    for a in range(SUBS):
        o = slice(a * SUB, a * SUB + SUB)
        sa.append(s.copy())
        sh, sl = split(s)
        t2[o] = mm((dyh[o], sh.T), (dyh[o], sl.T), (dyl[o], sh.T))
        s = (g[a][:, None] * s.astype(np.float64)
             + mm((kd[0][o].T, v[o]), (kd[1][o].T, v[o]))).astype(f32)
    # the reverse walk: G_a, <S_a, G_a>, T3 = G_a v, (k D) G_a, the update
    gm, t3 = g_out.copy(), np.zeros((Q, HD), f32)
    dvs, rsp = np.zeros((Q, HD), f32), np.zeros((SUBS, HD), f32)
    for a in reversed(range(SUBS)):
        o = slice(a * SUB, a * SUB + SUB)
        gh, gl = split(gm)
        rsp[a] = (sa[a].astype(np.float64) * gm).sum(1)
        t3[o] = mm((v[o], gh.T), (v[o], gl.T))
        dvs[o] = mm((kd[0][o], gh), (kd[0][o], gl), (kd[1][o], gh))
        gm = (g[a][:, None] * gm.astype(np.float64)
              + mm((re[0][o].T, dyh[o]), (re[0][o].T, dyl[o]),
                   (re[1][o].T, dyh[o]))).astype(f32)
    # the chains, vectorised over the channels
    dr, dk, dv, dw = (np.zeros((Q, HD), f32) for _ in range(4))
    below = np.tril(np.ones((SUB, SUB), bool), -1)
    for a in range(SUBS):
        o = a * SUB
        sl = slice(o, o + SUB)
        da = np.where(below, mm((dyh[sl], v[sl].T), (dyl[sl], v[sl].T)), 0
                      ).astype(f32)
        ad = np.zeros((SUB, SUB), f32)
        rect = np.zeros((SUB, HD), f32)
        rho = np.zeros((SUB, HD), f32)
        run_e = np.ones(HD, f32)
        for tt in range(SUB):
            ee, acc = np.ones(HD, f32), np.zeros(HD, f32)
            dterm = np.zeros((SUB, HD), f32)
            for s_ in range(tt - 1, -1, -1):
                cc = (k[o + s_] * ee).astype(f32)
                dterm[s_] = da[tt, s_] * cc
                acc = (acc + dterm[s_]).astype(f32)
                ad[tt, s_] = f32((r[o + tt].astype(np.float64) * cc).sum())
                ee = (ee * x[o + s_]).astype(f32)
            pr = np.zeros(HD, f32)
            for s_ in range(1, tt):
                pr = (pr + dterm[s_ - 1]).astype(f32)
                rect[s_] = (rect[s_] + r[o + tt] * pr).astype(f32)
            rho[tt] = run_e * r[o + tt] * t2[o + tt]
            dr[o + tt] = run_e * t2[o + tt] + acc + u * k[o + tt] * vd[o + tt]
            run_e = (run_e * x[o + tt]).astype(f32)
        bnd = (run_e * rsp[a]).astype(f32)
        pre = np.zeros(HD, f32)
        for s_ in range(SUB):
            ee, acc = np.ones(HD, f32), np.zeros(HD, f32)
            for tt in range(s_ + 1, SUB):
                acc = (acc + da[tt, s_] * (r[o + tt] * ee)).astype(f32)
                ee = (ee * x[o + tt]).astype(f32)
            t3s = t3[o + s_]
            dk[o + s_] = ee * t3s + acc + u * r[o + s_] * vd[o + s_]
            dw[o + s_] = bnd + rho[s_ + 1:].sum(0) + pre + rect[s_]
            pre = (pre + ee * k[o + s_] * t3s).astype(f32)
        ah, al = split(ad.T, a_split)
        dv[sl] = (dvs[sl] + mm((ah, dyh[sl]), (ah, dyl[sl]), (al, dyh[sl]))
                  + ruk[sl, None] * (dyh[sl] + dyl[sl]))
    du = (r.astype(np.float64) * k * vd[:, None]).sum(0).astype(f32)
    return dr, dk, dv, dw, du


def model_wkv_bwd(r, k, v, w, u, s0, dy, ds_t, a_split=True):
    """The four kernels of rwkv6_wkv_bwd (rows past T: zeros, x = 1)."""
    bsz, t, h, _ = r.shape
    chunks = -(-t // Q)
    pad = ((0, 0), (0, chunks * Q - t), (0, 0), (0, 0))
    r, k, v, w, dy = (np.pad(a.astype(f32), pad) for a in (r, k, v, w, dy))
    x = np.exp(w).astype(f32)
    states = np.zeros((chunks, 2, bsz, h, HD, HD), f32)
    decay = np.zeros((chunks, bsz, h, HD), f32)
    for c, bb, hh in itertools.product(range(chunks), range(bsz), range(h)):
        sl = slice(c * Q, c * Q + Q)
        states[c, 0, bb, hh], states[c, 1, bb, hh], decay[c, bb, hh] = \
            chunk_kernel(r[bb, sl, hh], k[bb, sl, hh], v[bb, sl, hh],
                         x[bb, sl, hh], dy[bb, sl, hh])
    for kind, start in ((0, s0), (1, ds_t)):
        cur = np.zeros((bsz, h, HD, HD), f32) if start is None \
            else start.astype(f32)
        for c in (range(chunks) if kind == 0 else reversed(range(chunks))):
            cur, states[c, kind] = (
                decay[c][..., None].astype(np.float64) * cur
                + states[c, kind]).astype(f32), cur
    ds0 = cur
    grads = [np.zeros((bsz, chunks * Q, h, HD), f32) for _ in range(4)]
    du = np.zeros((bsz, chunks, h, HD), f32)
    for c, bb, hh in itertools.product(range(chunks), range(bsz), range(h)):
        sl = slice(c * Q, c * Q + Q)
        out = grad_kernel(r[bb, sl, hh], k[bb, sl, hh], v[bb, sl, hh],
                          x[bb, sl, hh], dy[bb, sl, hh], u[hh].astype(f32),
                          states[c, 0, bb, hh], states[c, 1, bb, hh],
                          min(Q, t - c * Q), a_split)
        for grad, o in zip(grads, out):
            grad[bb, sl, hh] = o
        du[bb, c, hh] = out[4]
    return (*(gr[:, :t] for gr in grads), du.sum((0, 1), dtype=f32), ds0)


def decay_of(kind, z):
    """chip_smoke.py's wkv_decay."""
    if kind == "model":
        return -np.exp(z * 0.5 - 2.0)
    if kind == "strong":
        return -(12.5 + 7.5 * np.tanh(z))
    return -1e-4 * (1.0 + 0.5 * np.tanh(z))


CASES = {  # name: (B, T, H, decay, s0 and a final-state cotangent)
    "ragged": (1, 150, 2, "model", False),
    "short": (2, 40, 1, "model", True),
    "s0 strong": (1, 150, 2, "strong", True),
    "s0 weak": (1, 200, 2, "weak", True),
}


def case_inputs(name):
    bsz, t, h, kind, states = CASES[name]
    rng = np.random.RandomState(0)
    r, k, v = (bf16(rng.randn(bsz, t, h, HD).astype(f32)) for _ in range(3))
    w = decay_of(kind, rng.randn(bsz, t, h, HD)).astype(f32)
    u = (rng.randn(h, HD) * 0.5).astype(f32)
    dy = rng.randn(bsz, t, h, HD).astype(f32)
    s0 = (rng.randn(bsz, h, HD, HD) * 2).astype(f32) if states else None
    ds_t = rng.randn(bsz, h, HD, HD).astype(f32) if states else None
    return r, k, v, w, u, s0, dy, ds_t


def reference(args):
    return ref_rwkv6_bwd(*(None if a is None else torch.tensor(a)
                           for a in args))


def rel(got, want):
    want = want.numpy().astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_ref_rwkv6_bwd(name):
    args = case_inputs(name)
    got = model_wkv_bwd(*args)
    want = reference(args)
    errs = {n: rel(g, w) for n, g, w in zip(NAMES, got, want)}
    assert all(np.isfinite(g).all() for g in got)
    assert max(errs.values()) <= REL, errs


def test_one_bf16_rounding_of_a_misses_the_limit():
    """The counter-case: A's diagonal blocks without their lo term miss
    1e-4 in dv."""
    args = case_inputs("ragged")
    got = model_wkv_bwd(*args, a_split=False)
    assert rel(got[2], reference(args)[2]) > REL


def dw_by_reverse_sums(r, k, v, w, dy):
    """dw of one chunk from zero state and cotangent as the usual chunked
    form sums it: one level of chains over the chunk's 64 steps, dw_s =
    sum_{t>s} r_t dr_t - sum_{t>=s} k_t dk_t (the intra-chunk parts)."""
    x = np.exp(w).astype(f32)
    dyh, dyl = split(dy)
    da = np.where(np.tril(np.ones((Q, Q), bool), -1),
                  mm((dyh, v.T), (dyl, v.T)), 0).astype(f32)
    rho, kap = np.zeros((Q, HD), f32), np.zeros((Q, HD), f32)
    for t in range(Q):
        ee, acc = np.ones(HD, f32), np.zeros(HD, f32)
        for s in range(t - 1, -1, -1):
            acc = (acc + da[t, s] * (k[s] * ee)).astype(f32)
            ee = (ee * x[s]).astype(f32)
        rho[t] = r[t] * acc
    for s in range(Q):
        ee, acc = np.ones(HD, f32), np.zeros(HD, f32)
        for t in range(s + 1, Q):
            acc = (acc + da[t, s] * (r[t] * ee)).astype(f32)
            ee = (ee * x[t]).astype(f32)
        kap[s] = k[s] * acc
    return np.array([rho[s + 1:].sum(0, dtype=f32) - kap[s:].sum(0, dtype=f32)
                     for s in range(Q)])


def test_dw_as_reverse_sums_misses_the_limit_under_a_strong_decay():
    """The counter-case the design avoids: under a log decay of -5 to -20 a
    step the two reverse sums are ~1 and cancel to dw ~1e-2 (their
    adjacent-step terms carry no decay), so their float32 roundings miss
    1e-4 norm-wise; the kernel's rectangle, each term carrying x_s, and
    its model hold it."""
    rng = np.random.RandomState(1)
    r, k, v = (bf16(rng.randn(1, Q, 1, HD).astype(f32)) for _ in range(3))
    w = decay_of("strong", rng.randn(1, Q, 1, HD)).astype(f32)
    dy = rng.randn(1, Q, 1, HD).astype(f32)
    u = np.zeros((1, HD), f32)
    args = (r, k, v, w, u, None, dy, None)
    want = reference(args)[3]
    got = dw_by_reverse_sums(r[0, :, 0], k[0, :, 0], v[0, :, 0], w[0, :, 0],
                             dy[0, :, 0])
    assert rel(got[None, :, None], want) > REL
    assert rel(model_wkv_bwd(*args)[3], want) <= REL


def test_the_wrapper_copies_a_misaligned_fp32_operand(monkeypatch):
    """dy, s0 and ds_t are loaded in 16-byte vectors: a view whose base is
    not 16-byte aligned reaches the kernels as an aligned copy, not as a
    misaligned address; r, k, v and w keep the forward's rule (raise)."""
    from repro_torch.kernels import rwkv6
    from test_torch_ssd_bwd_layout import fake_card, misaligned
    seen = fake_card(monkeypatch, rwkv6, "rwkv6_wkv_bwd")
    monkeypatch.setattr(rwkv6.RWKV6_WKV_BWD, "count", 0)
    b, t, h = 1, 8, 2
    r, k, v = (torch.randn(b, t, h, HD).to(torch.bfloat16) for _ in range(3))
    w = -torch.rand(b, t, h, HD)
    s0, dy, ds_t = misaligned(b, h, HD, HD), misaligned(b, t, h, HD), \
        misaligned(b, h, HD, HD)
    rwkv6.rwkv6_wkv_bwd(r, k, v, w, torch.randn(h, HD), s0, dy, ds_t)
    args = seen["args"]
    for i in (5, 6, 7):                     # s0, dy, dsT
        assert args[i] % 16 == 0
    assert rwkv6.RWKV6_WKV_BWD.count == 1
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6.rwkv6_wkv_bwd(r, k, v, misaligned(b, t, h, HD),
                            torch.randn(h, HD), None, dy, None)
