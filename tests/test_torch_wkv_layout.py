"""``rwkv6_wkv``'s Hopper kernel (``csrc/rwkv6.cu``), the parts the CPU can
reach: numpy models of its index arithmetic and of its arithmetic.

- The shared-memory plan, the grid (one block per (b, h), every value
  column in its one warpgroup), the ragged last chunk.
- The TMA boxes of r, k, v (bf16, 128-byte swizzled) and w (fp32,
  unswizzled) over [B, T, H, 64], rows past T zero-filled; the wrapper's
  16-byte rule on their base addresses.
- The wgmma descriptors through the 128-byte swizzle: S and V N-major
  through the transpose bit (R S, A V, the state update's B), k .* D
  K-major at each column block's rows (the scores), K' M-major (the state
  update's A).
- Registers: ``build_frag``'s walk as the A fragment of each k16 step, an
  m64n16 score accumulator as the A fragment of A V's step, ``write_s``'s
  accumulator into the N-major S tile.
- The kernel's arithmetic modelled whole: per block (b, h) and chunk the
  warps' decays (x = e^w, 1 past T; E, G, D as products), the row factors
  of each pair of sub-chunks, the scaled operands as bf16 hi / lo pairs,
  every product through its descriptors with bf16 operands and float32
  sums, the diagonal chains, the bonus, S carried in float32; held
  against ``ref_rwkv6`` norm-wise within 1e-4 (the limit ``chip_smoke.py``
  holds the kernel to on the card) at a ragged T from a random s0, under
  the model's decays, a trained model's, a strong decay (log decay -5 to
  -20 a step, where a factor e^(+W) within a chunk overflows) and a weak
  one (-1e-4 a step: S grows over the sequence).  The counter-case, the
  scaled operands rounded once to bf16, exceeds 1e-4.

The models read the kernel's constants (HD, Q, kSub, kStages, kSplit,
kRow, kSmemMax) from the source, so a change to its tiling runs through
them; the kernel itself runs only on the card (``chip_smoke.py`` phase 1).
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _tma_model import a_frag_pos, acc_pos, read_kmajor, read_mnmajor, sw128

from repro_torch.kernels.ref import ref_rwkv6
from repro_torch.kernels.rwkv6 import CHUNK, tma_base_rule

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/rwkv6.cu").read_text()
CONSTS: dict = {}


def source_constant(name: str) -> int:
    """The value a ``constexpr int`` of rwkv6.cu is set to (an expression
    of the constants read before it)."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);", SOURCE)
    assert len(found) == 1, f"rwkv6.cu sets {name} {len(found)}x"
    CONSTS[name] = int(eval(found[0].split("//")[0], {}, dict(CONSTS)))
    return CONSTS[name]


HD = source_constant("HD")                  # head size
Q = source_constant("Q")                    # steps a chunk
SUB = source_constant("kSub")               # steps a sub-chunk (a warp)
STAGES = source_constant("kStages")         # the r / k / v / w ring
SPLIT = source_constant("kSplit")           # bf16 terms of a pair
SMEM_MAX = source_constant("kSmemMax")      # a block's dynamic smem
ROW = source_constant("kRow")               # padded fp32 row (floats)
WARPS = Q // SUB
TILE = Q * 128                              # 64 rows of 64 bf16
F32 = np.float32
REL = 1e-4                                  # chip_smoke.py's REC_REL


def smem_plan():
    """Byte offsets of rwkv6.cu's shared memory and the bytes the launch
    asks for."""
    stage = 3 * TILE + Q * HD * 4
    f32 = Q * ROW * 4
    plan = {}
    for st in range(STAGES):
        for i, name in enumerate("rkv"):
            plan[f"{name}{st}"] = st * stage + i * TILE
        plan[f"w{st}"] = st * stage + 3 * TILE
    at = STAGES * stage
    for name, size in (("kt", SPLIT * TILE), ("kp", SPLIT * TILE),
                       ("ss", SPLIT * TILE), ("re", f32), ("rf", f32),
                       ("xf", f32), ("ad", WARPS * SUB * SUB * 4),
                       ("g", WARPS * HD * 4), ("f", WARPS * WARPS * HD * 4),
                       ("gt", HD * 4), ("u", HD * 4),
                       ("bar", 2 * STAGES * 8)):
        plan[name] = at
        at += size
    plan["bytes"] = at + 1024
    return plan


def test_shared_memory_plan_fits_and_aligns():
    """The swizzled tiles (the ring's r, k, v; the k .* D, K' and S pairs)
    sit on 1024-byte boundaries, the fp32 tiles and the w boxes on 16-byte
    ones (float4 reads, TMA), the barriers on 8; the plan fits a block's
    limit at one block an SM, and the padded fp32 row keeps float4 reads
    aligned."""
    plan = smem_plan()
    assert plan["bytes"] <= SMEM_MAX
    swizzled = [k for k in plan if k[0] in "rkv" and k[1:].isdigit()]
    for name in swizzled + ["kt", "kp", "ss"]:
        assert plan[name] % 1024 == 0, name
    for name in ("re", "rf", "xf", "ad", "g", "f", "gt", "u") + tuple(
            f"w{st}" for st in range(STAGES)):
        assert plan[name] % 128 == 0 or plan[name] % 16 == 0, name
    assert plan["bar"] % 8 == 0 and (ROW * 4) % 16 == 0
    # 2 x 40 KB of ring, three 16 KB pairs, three 18 KB fp32 tiles and the
    # small arrays: one block an SM
    assert 2 * plan["bytes"] > SMEM_MAX


def test_grid_covers_every_head_and_value_column_once():
    """One block per (b, h): block i takes (i // H, i % H); its one
    warpgroup's m64n64 accumulator holds every (row, value column) of a
    chunk once, warp a the rows of sub-chunk a; the chunks cover T with a
    ragged last one (rows past T not stored)."""
    for bsz, h in ((4, 32), (1, 32), (3, 5)):
        seen = [divmod(i, h) for i in range(bsz * h)]
        assert sorted(seen) == list(itertools.product(range(bsz), range(h)))
    hits = np.zeros((Q, HD), np.int64)
    for t in range(128):
        for i in range(32):
            row, col = acc_pos(t, i)
            assert row // SUB == t // 32          # warp a, sub-chunk a
            hits[row, col] += 1
    assert (hits == 1).all()
    for t in (64, 150, 2000, 2048):
        chunks = -(-t // Q)
        stored = sum(min(Q, t - c * Q) for c in range(chunks))
        assert stored == t
    assert CHUNK == Q


# ---------------------------------------------------------------------------
# bf16 and the pair
# ---------------------------------------------------------------------------

def bf16(a):
    """Round float32 to bf16 (nearest, ties to even), as float32."""
    u = np.asarray(a, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def split(v, pair=True):
    """split2: hi = bf16(v), lo = bf16(v - hi); without ``pair``, one
    rounding (lo 0)."""
    v = np.asarray(v, F32)
    hi = bf16(v)
    return (hi, bf16(v - hi)) if pair else (hi, np.zeros_like(hi))


def test_the_pair_keeps_sixteen_bits():
    rng = np.random.RandomState(0)
    v = (rng.randn(100000) * np.exp(rng.randn(100000) * 4)).astype(F32)
    hi, lo = split(v)
    rel = np.abs(v - (hi.astype(np.float64) + lo)) / np.abs(v)
    assert rel.max() <= 2.0 ** -16


# ---------------------------------------------------------------------------
# registers
# ---------------------------------------------------------------------------

def build_frag_pos(t, kk, jr, jh, e):
    """build_frag: register jr + 2 jh of k16 step kk of thread t holds
    (row0 + 8 jr, channel 16 kk + 8 jh + 2 q4 + e)."""
    w, lane = t >> 5, t & 31
    return 16 * w + (lane >> 2) + 8 * jr, 16 * kk + 8 * jh + 2 * (lane & 3) + e


def test_build_frag_is_the_a_fragment():
    """Every (row, channel) of the 64 x 64 operand lands once, where wgmma's
    A fragment of its k16 step expects it."""
    seen = np.zeros((Q, HD), np.int64)
    for t, kk, jr, jh, e in itertools.product(range(128), range(4), range(2),
                                              range(2), range(2)):
        row, ch = build_frag_pos(t, kk, jr, jh, e)
        arow, ak = a_frag_pos(t, jr + 2 * jh, e)
        assert (row, ch) == (arow, 16 * kk + ak)
        seen[row, ch] += 1
    assert (seen == 1).all()


def test_score_accumulator_is_the_a_fragment_of_a_v():
    """Register 4 jj + 2 half + e of an m64n16 score accumulator (column
    block cb) is half e of A register half + 2 jj of A V's k16 step cb; the
    diagonal chain's entry read beside it is the same (row, s)."""
    for t, jj, half, e in itertools.product(range(128), range(2), range(2),
                                            range(2)):
        row, col = acc_pos(t, 4 * jj + 2 * half + e)
        assert (row, col) == a_frag_pos(t, half + 2 * jj, e)
        lane = t & 31
        assert (row % SUB, col) == ((lane >> 2) + 8 * half,
                                    8 * jj + 2 * (lane & 3) + e)


def write_s(smem, at, s, pair=True):
    """write_s: register pair i of each thread's accumulator S[i][j] as its
    bf16 pair, N-major [i][j] at ``at`` (hi) and ``at`` + TILE (lo)."""
    for t in range(128):
        for i in range(0, 32, 2):
            ri, cj = acc_pos(t, i)
            hi, lo = split(s[ri, cj:cj + 2], pair)
            off = sw128(ri * 128 + cj * 2 + np.arange(2) * 2)
            smem[(at + off) // 2] = hi
            smem[(at + TILE + off) // 2] = lo


def test_s_tile_reads_back_as_the_b_operand():
    """The S pair written from the accumulator, read through R S's N-major
    descriptors (K = i, 16 rows a step), is S's hi and lo."""
    rng = np.random.RandomState(2)
    s = rng.randn(HD, HD).astype(F32)
    smem = np.full(2 * TILE // 2, np.nan, F32)
    write_s(smem, 0, s)
    hi, lo = split(s)
    for kk in range(4):
        for part, want in ((0, hi), (TILE, lo)):
            got = read_mnmajor(smem, 2, part + kk * 2048, HD, 16, lbo=TILE)
            np.testing.assert_array_equal(got.T, want[16 * kk:16 * kk + 16])


# ---------------------------------------------------------------------------
# TMA and the wrapper's rule
# ---------------------------------------------------------------------------

def tma_rows(arr, b, hh, t0):
    """The box {HD, 1, Q, 1} at (0, hh, t0, b) of a [B, T, H, HD] array:
    [Q, HD], rows past T zero."""
    out = np.zeros((Q, HD), F32)
    n = max(0, min(Q, arr.shape[1] - t0))
    out[:n] = arr[b, t0:t0 + n, hh]
    return out


def tma_swizzled(smem, dst, rows):
    """The bf16 box landing 128-byte swizzled at ``dst``."""
    assert dst % 1024 == 0
    r, e = np.meshgrid(np.arange(Q), np.arange(HD), indexing="ij")
    smem[(dst + sw128(r * 128 + e * 2)) // 2] = rows


def tile_rows(smem, src):
    """Row t, channel i of a swizzled bf16 tile, as the CUDA cores read it
    (swz(t, 2 i))."""
    r, e = np.meshgrid(np.arange(Q), np.arange(HD), indexing="ij")
    return smem[(src + sw128(r * 128 + e * 2)) // 2]


def test_tma_box_lands_rows_below_t_and_zeros_past_it():
    rng = np.random.RandomState(3)
    arr = bf16(rng.randn(2, 150, 3, HD).astype(F32))
    smem = np.full(TILE // 2, np.nan, F32)
    for b, hh, t0 in ((0, 0, 0), (1, 2, 128), (1, 1, 64)):
        tma_swizzled(smem, 0, tma_rows(arr, b, hh, t0))
        got = tile_rows(smem, 0)
        n = min(Q, 150 - t0)
        np.testing.assert_array_equal(got[:n], arr[b, t0:t0 + n, hh])
        assert (got[n:] == 0).all()
        # wgmma's K-major read of rows 16 cb.. (the scores' B) is the same
        kmaj = np.concatenate([read_kmajor(smem, 2, 2048 + kk * 32, 16, 16)
                               for kk in range(4)], axis=1)
        np.testing.assert_array_equal(kmaj, got[16:32])


def test_tma_rule_takes_the_model_tensors_and_refuses_a_shifted_base():
    """rwkv6's r, k, v, w are [B, T, H*64] matmul outputs viewed as
    [B, T, H, 64]: aligned, and so is a batch or time slice made
    contiguous; a view one element on is refused."""
    x = torch.zeros((2, 100, 4 * HD), dtype=torch.bfloat16)
    heads = x.reshape(2, 100, 4, HD)
    tma_base_rule("r", heads.data_ptr())
    tma_base_rule("r", heads[1:].data_ptr())
    tma_base_rule("w", heads[:, 30:].contiguous().float().data_ptr())
    with pytest.raises(ValueError, match="rwkv6_wkv k: .*16-byte aligned"):
        tma_base_rule("k", x.view(-1)[1:].data_ptr())


# ---------------------------------------------------------------------------
# the kernel's arithmetic, whole
# ---------------------------------------------------------------------------

def decays(wt, nrows):
    """Step 1 of each warp, vectorized over warps and channels: x =
    expf(w) (1 past T, selected), E (the running product before each
    step), G (the sub-chunk's whole product)."""
    valid = (np.arange(Q) < nrows)[:, None]
    with np.errstate(under="ignore"):
        x = np.where(valid, np.exp(wt.astype(F32)), F32(1))
    x = x.astype(F32).reshape(WARPS, SUB, HD)
    e = np.ones((WARPS, HD), F32)
    big_e = np.zeros_like(x)
    for tau in range(SUB):
        big_e[:, tau] = e
        e = (e * x[:, tau]).astype(F32)
    return x, big_e, e


def factors(g):
    """Step 2: the row factors of each warp (set 0: the decay from the
    chunk's start; set 1 + cb: between column block cb's end and the
    warp's start, 0 where cb >= warp), the later sub-chunks' decay, and
    e^W_{Q-1}; products in the kernel's order."""
    f = np.zeros((WARPS, WARPS, HD), F32)
    later = np.ones((WARPS, HD), F32)
    for wp in range(WARPS):
        for cb in range(-1, WARPS - 1):
            v = np.ones(HD, F32)
            for gi in range(WARPS):
                if cb < gi < wp:
                    v = (v * g[gi]).astype(F32)
            f[wp, cb + 1] = v if cb < wp else 0
        for gi in range(wp + 1, WARPS):
            later[wp] = (later[wp] * g[gi]).astype(F32)
    total = np.ones(HD, F32)
    for gi in range(WARPS):
        total = (total * g[gi]).astype(F32)
    return f, later, total


def chain(kv, rf, x, u, wp):
    """diag_chains of warp ``wp``: lane (s-group, channel group of 8)
    carries k_s times x of each step passed; row t's entry is r_t . that,
    each group's partial summed in float32 and the 8 groups in reduce4's
    butterfly order; the bonus r_s . u k_s on the diagonal; zeros above
    it."""
    rows = slice(SUB * wp, SUB * wp + SUB)
    k_s, r_t, x_t = kv[rows], rf[rows], x[wp]
    acc = k_s.copy()

    def dot(a, b):
        p = np.sum((a * b).reshape(*np.broadcast_shapes(a.shape, b.shape)[:-1],
                                   8, 8), -1, dtype=F32)
        g = lambda c: p[..., c]
        return (((g(0) + g(4)) + (g(2) + g(6)))
                + ((g(1) + g(5)) + (g(3) + g(7)))).astype(F32)
    bonus = dot((r_t * u).astype(F32), k_s)
    out = np.zeros((SUB, SUB), F32)
    s = np.arange(SUB)
    out[0] = np.where(s == 0, bonus, 0)
    for t in range(1, SUB):
        d = dot(r_t[t][None], acc)
        out[t] = np.where(t > s, d, np.where(t == s, bonus, 0))
        with np.errstate(under="ignore"):
            acc = np.where((t > s)[:, None], acc * x_t[t], acc).astype(F32)
    return out


def test_reduce4_sums_every_channel_group_for_every_s():
    """reduce4's butterfly: the lane of s-group sg and channel group cg
    with bit 0 clear ends with the sum over all 8 groups of d[j], j = 2 b4
    + b3, and those lanes cover all 16 s = sg + 4 j once."""
    d = np.arange(32 * 4, dtype=np.float64).reshape(32, 4) ** 1.5

    def shfl(v, m):
        return v[np.arange(32) ^ m]
    lane = np.arange(32)
    b4, b3 = (lane >> 4) & 1, (lane >> 3) & 1
    k0, s0 = np.where(b4, d[:, 2], d[:, 0]), np.where(b4, d[:, 0], d[:, 2])
    k1, s1 = np.where(b4, d[:, 3], d[:, 1]), np.where(b4, d[:, 1], d[:, 3])
    e0, e1 = k0 + shfl(s0, 16), k1 + shfl(s1, 16)
    f = np.where(b3, e1, e0) + shfl(np.where(b3, e0, e1), 8)
    g = f + shfl(f, 4)
    covered = []
    for ln in range(32):
        if (ln >> 2) & 1:
            continue
        sg, j = ln & 3, 2 * b4[ln] + b3[ln]
        same = [m for m in range(32) if m & 3 == sg]
        assert np.isclose(g[ln], d[same, j].sum())
        covered.append(sg + 4 * j)
    assert sorted(covered) == list(range(SUB))


def mm(a, b):
    return np.matmul(a.astype(F32), b.astype(F32), dtype=F32)


def model_block(r, k, v, w, u, s0, pair=True):
    """rwkv6.cu's chunked kernel for one (b, h): r, k, v [T, HD] (bf16
    values), w [T, HD], u [HD], s0 [HD, HD] or None -> y [T, HD], the final
    S.  ``pair=False``: every scaled operand rounded once to bf16."""
    t_len = r.shape[0]
    plan = smem_plan()
    smem = np.full(plan["re"] // 2, np.nan, F32)
    s = np.zeros((HD, HD), F32) if s0 is None else s0.astype(F32)
    write_s(smem, plan["ss"], s, pair)
    y = np.full((t_len, HD), np.nan, F32)
    whole = [a[None, :, None] for a in (r, k, v, w)]
    for c in range(-(-t_len // Q)):
        st, t0 = c % STAGES, c * Q
        nrows = min(Q, t_len - t0)
        for name, arr in zip("rkv", whole):
            tma_swizzled(smem, plan[f"{name}{st}"], tma_rows(arr, 0, 0, t0))
        wt = tma_rows(whole[3], 0, 0, t0)
        rf = tile_rows(smem, plan[f"r{st}"])
        kv = tile_rows(smem, plan[f"k{st}"])
        vs = plan[f"v{st}"]
        # 1-2: decays, factors, k .* D and K' as pairs
        x, big_e, g = decays(wt, nrows)
        re_ = (rf.reshape(WARPS, SUB, HD) * big_e).astype(F32).reshape(Q, HD)
        f, later, total = factors(g)
        kd = np.zeros((Q, HD), F32)
        kl = np.zeros((Q, HD), F32)
        for wp in range(WARPS):
            d = np.ones(HD, F32)
            for tau in range(SUB - 1, -1, -1):
                t = SUB * wp + tau
                kd[t] = (kv[t] * d).astype(F32)
                kl[t] = (kd[t] * later[wp]).astype(F32)
                with np.errstate(under="ignore"):
                    d = (d * x[wp, tau]).astype(F32)
        r_, e_ = np.meshgrid(np.arange(Q), np.arange(HD), indexing="ij")
        off = sw128(r_ * 128 + e_ * 2)
        for at, val in ((plan["kt"], kd), (plan["kp"], kl)):
            hi, lo = split(val, pair)
            smem[(at + off) // 2] = hi
            smem[(at + TILE + off) // 2] = lo
        rows_w = np.arange(Q) // SUB

        def operand(fset):           # re .* factor of each row's warp
            return split((re_ * f[rows_w, fset]).astype(F32), pair)
        # 3: y = R S_0 (hi hi, hi lo, lo hi); S <- e^W S + K'^T V
        a_hi, a_lo = operand(0)
        yc = np.zeros((Q, HD), F32)
        for kk in range(4):
            ks = slice(16 * kk, 16 * kk + 16)
            sh, sl = (read_mnmajor(smem, 2, plan["ss"] + p + kk * 2048, HD, 16,
                                   lbo=TILE).T for p in (0, TILE))
            yc = yc + mm(a_hi[:, ks], sh) + mm(a_hi[:, ks], sl) \
                + mm(a_lo[:, ks], sh)
        s = (s * total[:, None]).astype(F32)
        for kk in range(Q // 16):
            vb = read_mnmajor(smem, 2, vs + kk * 2048, HD, 16, lbo=TILE).T
            for p in (0, TILE):
                ka = read_mnmajor(smem, 2, plan["kp"] + p + kk * 2048, HD, 16,
                                  lbo=TILE)
                s = s + mm(ka, vb)
        # 4: the diagonal chains
        diag = [chain(kv, rf, x, u, wp) for wp in range(WARPS)]
        write_s(smem, plan["ss"], s, pair)
        # 5: the scores of column blocks 0-2
        sc = []
        for cb in range(WARPS - 1):
            b_hi, b_lo = operand(cb + 1)
            acc = np.zeros((Q, SUB), F32)
            for kk in range(4):
                ks = slice(16 * kk, 16 * kk + 16)
                kh, kl_ = (read_kmajor(smem, 2, plan["kt"] + p + 2048 * cb
                                       + kk * 32, SUB, 16).T
                           for p in (0, TILE))
                acc = acc + mm(b_hi[:, ks], kh) + mm(b_hi[:, ks], kl_) \
                    + mm(b_lo[:, ks], kh)
            sc.append(acc)
        # 6: y += A V, A by warp and column block: scores below the
        # diagonal, the chain on it, zeros above
        a = np.zeros((Q, Q), F32)
        for wp in range(WARPS):
            rows = slice(SUB * wp, SUB * wp + SUB)
            for cb in range(WARPS):
                cols = slice(SUB * cb, SUB * cb + SUB)
                if cb < wp:
                    a[rows, cols] = sc[cb][rows]
                elif cb == wp:
                    a[rows, cols] = diag[wp]
        m_hi, m_lo = split(a, pair)
        for cb in range(WARPS):
            cols = slice(SUB * cb, SUB * cb + SUB)
            vb = read_mnmajor(smem, 2, vs + cb * 2048, HD, 16, lbo=TILE).T
            yc = yc + mm(m_hi[:, cols], vb) + mm(m_lo[:, cols], vb)
        # 7: rows below T stored
        y[t0:t0 + nrows] = yc[:nrows]
        assert np.isfinite(yc).all() and np.isfinite(s).all()
    return y, s


def model(r, k, v, w, u, s0, pair=True):
    bsz, t, h, _ = r.shape
    y = np.zeros((bsz, t, h, HD), F32)
    s_t = np.zeros((bsz, h, HD, HD), F32)
    for b, hh in itertools.product(range(bsz), range(h)):
        y[b, :, hh], s_t[b, hh] = model_block(
            r[b, :, hh], k[b, :, hh], v[b, :, hh], w[b, :, hh], u[hh],
            None if s0 is None else s0[b, hh], pair)
    return y, s_t


CASES = {  # name: (B, T, H, log decay a step, random s0)
    # the seeded model's decays: -exp(-2 + N(0, 0.5^2)), ~ -0.135
    "model, ragged, s0": (1, 150, 2, lambda g, n: -np.exp(g.randn(*n) * 0.5
                                                          - 2.0), True),
    # a trained model's: up to several units a step
    "trained": (1, 130, 1, lambda g, n: -np.exp(g.uniform(-6, 2, n)), True),
    # -5 to -20 a step: e^(+W) of a chunk overflows float32
    "strong decay": (1, 130, 1, lambda g, n: -g.uniform(5, 20, n), True),
    # -1e-4 a step: S grows over the sequence
    "weak decay": (1, 200, 1, lambda g, n: np.full(n, -1e-4) * (1 + g.rand(
        *n)), False),
}


def case_inputs(name):
    bsz, t, h, decay, with_s0 = CASES[name]
    rng = np.random.RandomState(len(name))
    r, k, v = (bf16(rng.randn(bsz, t, h, HD).astype(F32)) for _ in range(3))
    w = decay(rng, (bsz, t, h, HD)).astype(F32)
    u = (rng.randn(h, HD) * 0.5).astype(F32)
    s0 = (rng.randn(bsz, h, HD, HD) * 2).astype(F32) if with_s0 else None
    return r, k, v, w, u, s0


def reference(r, k, v, w, u, s0):
    return ref_rwkv6(*(torch.tensor(a) for a in (r, k, v, w, u)),
                     s0=None if s0 is None else torch.tensor(s0),
                     return_state=True)


def rel(got, want):
    want = want.numpy().astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_ref_rwkv6(name):
    args = case_inputs(name)
    y, s_t = model(*args)
    want_y, want_s = reference(*args)
    assert np.isfinite(y).all() and np.isfinite(s_t).all()
    assert rel(y, want_y) <= REL and rel(s_t, want_s) <= REL, (
        rel(y, want_y), rel(s_t, want_s))


def test_one_bf16_rounding_of_the_scaled_operands_misses_the_limit():
    """The counter-case: without the lo terms the same model misses 1e-4."""
    args = case_inputs("model, ragged, s0")
    y, s_t = model(*args, pair=False)
    want_y, want_s = reference(*args)
    assert max(rel(y, want_y), rel(s_t, want_s)) > REL


def test_rows_past_t_leave_every_decay_exactly():
    """x is 1 past T (selected), so E, G and the suffix products of a
    ragged chunk are bitwise those of its rows below T alone, and a state
    carried through the padding is unchanged."""
    rng = np.random.RandomState(4)
    wt = (-np.exp(rng.randn(Q, HD))).astype(F32)
    nrows = 37
    x, big_e, g = decays(wt, nrows)
    assert (x.reshape(Q, HD)[nrows:] == 1).all()
    wp, last = divmod(nrows - 1, SUB)
    e = big_e[wp, last] * x[wp, last]
    np.testing.assert_array_equal(g[wp], e.astype(F32))
    assert (g[wp + 1:] == 1).all()
    f, later, total = factors(g)
    direct = np.ones(HD, F32)
    for gi in range(wp + 1):
        direct = (direct * g[gi]).astype(F32)
    np.testing.assert_array_equal(total, direct)
