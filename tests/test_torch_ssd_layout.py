"""``ssd_scan``'s Hopper kernel (``csrc/ssd.cu``), the parts the CPU can
reach: numpy models of its index arithmetic and of its arithmetic.

- The TMA boxes over zamba2's strided slices of one projection (x a 4-D
  map over [B, T, H, P], B and C 3-D maps over [B, T, N], each through the
  caller's batch and time strides, rows past T zero-filled), the
  wrapper's 16-byte rule on those strides, y's stores from the
  accumulator (rows past T not stored).
- The wgmma descriptors through the 128-byte swizzle: C and B K-major (S =
  C B^T, C h^T with h K-major), x N-major through the transpose bit (M x),
  x^T as the M-major A operand and cw .* B N-major (the state update).
- The S accumulator read as M's A fragments, the bf16 pair (hi, lo) of M,
  h and cw .* B, the dt mask after the softplus.
- The shared-memory plan, the grid.
- The kernel's arithmetic modelled whole: per block (b, h) the producer's
  L / dt / cw, the TMA loads into the shared-memory plan, every product
  through its descriptors with bf16 operands and float32 sums, M from the
  accumulator registers as A fragments, the y stores,
  h carried in float32 and handed over as its bf16 pair; held against
  ``ref_ssd`` norm-wise within 1e-4 (the limit ``chip_smoke.py`` holds the
  kernel to on the card) at a ragged T, from a random h0 and under a
  strong decay that overflows exp above the diagonal.  The counter-case,
  M rounded once to bf16, exceeds 1e-4.

The models read the kernel's constants (Q, P, N, kStages, kSplit,
kSmemMax) from the source, so a change to its tiling runs
through them; the kernel itself runs only on the card (``chip_smoke.py``
phase 1).
"""
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _tma_model import a_frag_pos, acc_pos, read_kmajor, read_mnmajor, sw128

from repro_torch.kernels.ref import ref_ssd
from repro_torch.kernels.ssd import tma_strides

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/ssd.cu").read_text()


def source_constant(name: str) -> int:
    """The value a ``constexpr int`` of ssd.cu is set to."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);", SOURCE)
    assert len(found) == 1, f"ssd.cu sets {name} {len(found)}x"
    return int(found[0].split("//")[0].strip())


Q = source_constant("Q")                    # steps a chunk
P = source_constant("P")                    # head size
N = source_constant("N")                    # state size
STAGES = source_constant("kStages")         # the x / B / C ring
SPLIT = source_constant("kSplit")           # bf16 terms of M, h, cw B
SMEM_MAX = source_constant("kSmemMax")      # a block's dynamic smem
LOG2E = np.float32(1.4426950408889634)
TILE = Q * 128                              # 128 rows of 64 bf16
REL = 1e-4                                  # chip_smoke.py's REC_REL


def smem_plan():
    """Byte offsets of ssd.cu's shared memory and the bytes the launch asks
    for: per stage x, B, C; the h pair; the cw B pair; per stage L, dt,
    cw, colf; the barriers."""
    stage, hsz, arr = 3 * TILE, P * 128, 4 * Q * 4
    plan = {}
    for st in range(STAGES):
        plan[f"x{st}"] = st * stage
        plan[f"b{st}"] = st * stage + TILE
        plan[f"c{st}"] = st * stage + 2 * TILE
    plan["hhi"] = STAGES * stage
    plan["hlo"] = plan["hhi"] + hsz
    plan["cwhi"] = plan["hhi"] + SPLIT * hsz
    plan["cwlo"] = plan["cwhi"] + TILE
    for st in range(STAGES):
        plan[f"arr{st}"] = plan["cwhi"] + SPLIT * TILE + st * arr
    plan["bar"] = plan["cwhi"] + SPLIT * TILE + STAGES * arr
    plan["bytes"] = plan["bar"] + 2 * STAGES * 8 + 1024
    return plan


SIZES = {"x": TILE, "b": TILE, "c": TILE, "hhi": P * 128, "hlo": P * 128,
         "cwhi": TILE, "cwlo": TILE, "arr": 4 * Q * 4}


def test_shared_memory_plan_fits_and_aligns():
    """The tiles sit on 1024-byte boundaries (the swizzle's atom), end to
    end; the plan fits a block's limit at one block an SM (the design runs
    one: registers, ~160 a thread, rule out two)."""
    plan = smem_plan()
    assert plan["bytes"] <= SMEM_MAX
    regions = sorted((v, k) for k, v in plan.items() if k != "bytes")
    for (off, name), (nxt, _) in zip(regions, regions[1:]):
        size = SIZES[name.rstrip("0123456789")]
        assert off + size == nxt, (name, off, size, nxt)
        if not name.startswith("arr"):
            assert off % 1024 == 0, name
    assert plan["bar"] % 8 == 0


def test_grid_covers_every_batch_row_and_head_once():
    """One block per (b, h): block i takes (i // H, i % H); 4 x 64 heads
    is 256 blocks (two waves of one block an SM on 132 SMs), a 1 x 2048
    request 64."""
    for bsz, h in ((4, 64), (1, 64), (3, 5)):
        seen = [divmod(i, h) for i in range(bsz * h)]
        assert sorted(seen) == list(itertools.product(range(bsz), range(h)))
    assert math.ceil(4 * 64 / 132) == 2


# ---------------------------------------------------------------------------
# bf16 and the pair
# ---------------------------------------------------------------------------

def bf16(a):
    """Round float32 to bf16 (nearest, ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def split(v):
    """split2: hi = bf16(v), lo = bf16(v - hi)."""
    v = np.asarray(v, np.float32)
    hi = bf16(v)
    return hi, bf16(v - hi)


def test_the_pair_keeps_sixteen_bits():
    """hi + lo is within 2^-16 of v relative (one bf16 rounding: 2^-8);
    bf16 values are their own hi, with lo 0."""
    rng = np.random.RandomState(0)
    v = (rng.randn(100000) * np.exp(rng.randn(100000) * 4)).astype(np.float32)
    hi, lo = split(v)
    rel = np.abs(v - (hi.astype(np.float64) + lo)) / np.abs(v)
    assert rel.max() <= 2.0 ** -16
    assert np.abs(v - hi).max() > 0 and (np.abs(v - hi) / np.abs(v)).max() \
        <= 2.0 ** -8
    b = bf16(v)
    assert (split(b)[0] == b).all() and (split(b)[1] == 0).all()


# ---------------------------------------------------------------------------
# registers: the S accumulator as M's A fragments (make_m)
# ---------------------------------------------------------------------------

def make_m_regs(ns):
    """make_m's walk: for step c, column group jj, row half, element e, the
    accumulator register i = 8c + 4jj + 2half + e that lands in A register
    j = half + 2jj, half e."""
    for c, jj, half, e in itertools.product(range(ns // 16), range(2),
                                            range(2), range(2)):
        yield c, 8 * c + 4 * jj + 2 * half + e, half + 2 * jj, e


@pytest.mark.parametrize("ns", [64, 128])
def test_accumulator_is_the_a_fragment_of_m_x(ns):
    """Every (row, s) of the 64 x ns S tile sits in one register, and
    make_m's packing puts it where the A fragment of k16 step s // 16
    expects (row, s % 16)."""
    seen = np.zeros((64, ns), np.int64)
    for t in range(128):
        for c, i, j, e in make_m_regs(ns):
            row, col = acc_pos(t, i)
            arow, ak = a_frag_pos(t, j, e)
            assert (row, col) == (arow, 16 * c + ak)
            seen[row, col] += 1
    assert (seen == 1).all()


def frag_index(ns):
    """[step][4 arrays]: A-fragment (row, k) and accumulator (row, col) of
    every half-register of the step, over the warpgroup's 128 threads."""
    idx = np.zeros((ns // 16, 4, 128 * 8), np.int64)
    fill = np.zeros(ns // 16, np.int64)
    for t in range(128):
        for c, i, j, e in make_m_regs(ns):
            k = fill[c]
            idx[c, :, k] = a_frag_pos(t, j, e) + acc_pos(t, i)
            fill[c] += 1
    return idx


FRAG = {ns: frag_index(ns) for ns in (64, 128)}
# the n64 accumulator's (row, column) of every (thread, register)
ACC64 = np.array([[acc_pos(t, i) for i in range(32)] for t in range(128)])


def a_fragment(m, step):
    """The A operand of k16 step ``step`` as the registers hold it, from
    the accumulator-shaped M [64, ns]."""
    a = np.full((64, 16), np.nan, np.float32)
    ar, ak, pr, pc = FRAG[m.shape[1]][step]
    a[ar, ak] = m[pr, pc]
    return a


# ---------------------------------------------------------------------------
# TMA over strided slices
# ---------------------------------------------------------------------------

def tma_load(smem, dst, mem, base, dims, strides, coord):
    """TMA load of a box of 64 innermost elements by the product of the
    other dims' boxes (``coord``: the box's start, ``dims``: the map's
    extents, innermost first, box 64 x Q along the time dim, 1 elsewhere)
    from the flat element array ``mem`` (element (i0, i1, ...) at base + i0
    + sum i_k strides[k - 1]) into ``smem`` at byte ``dst``, rows of 128
    bytes, 128-byte swizzled; out of bounds reads 0."""
    assert dst % 1024 == 0
    tdim = len(dims) - 2                      # time: the second-last dim
    r, e = np.meshgrid(np.arange(Q), np.arange(64), indexing="ij")
    pos = [coord[0] + e] + [np.full_like(r, c) for c in coord[1:]]
    pos[tdim] = coord[tdim] + r
    inb = np.ones_like(r, bool)
    addr = np.full_like(r, base)
    for k, (pk, dk) in enumerate(zip(pos, dims)):
        inb &= pk < dk
        addr = addr + pk * (1 if k == 0 else strides[k - 1])
    vals = np.where(inb, mem[np.where(inb, addr, 0)], 0.0)
    smem[(dst + sw128(r * 128 + e * 2)) // 2] = vals


def store_y(out, y, b, hh, t0, wg):
    """store_y: thread (warp w, lane l) of warpgroup wg writes register pair
    i of its 64 x P accumulator tile to flat element (b T + t0 + row) H P +
    hh P + col of y, row = 64 wg + r + 8 half, when r + 8 half < T - t0 -
    64 wg."""
    bsz, t, h, _ = out.shape
    flat = out.reshape(-1)
    ystride = h * P
    nrows = t - t0 - 64 * wg
    for th in range(128):
        w, lane = th >> 5, th & 31
        r, q4 = 16 * w + (lane >> 2), lane & 3
        base = (b * t + 64 * wg + r) * ystride + hh * P + t0 * ystride
        for i in range(0, 32, 2):
            half, col = (i >> 1) & 1, 8 * (i >> 2) + 2 * q4
            if r + 8 * half < nrows:
                at = base + half * 8 * ystride + col
                flat[at:at + 2] = y[r + 8 * half, col:col + 2]


def projection(rng, bsz, t, h, width_extra=0):
    """A [B, T, H*P + 2N (+ extra)] bf16 projection as a flat float32
    array, and x, B, C as (base, dims, strides) maps of its slices, the
    model's ``torch.split(xbc, [H*P, N, N])``."""
    w = h * P + 2 * N + width_extra
    mem = bf16(rng.randn(bsz * t * w).astype(np.float32))
    xs = tma_strides("x", (bsz, t, h, P), (t * w, w, P, 1), 2, 0)
    bs = tma_strides("b", (bsz, t, N), (t * w, w, 1), 2, h * P * 2)
    maps = {"x": (0, (P, h, t, bsz), (P,) + xs[::-1]),
            "b": (h * P, (N, t, bsz), bs[::-1]),
            "c": (h * P + N, (N, t, bsz), bs[::-1])}
    return mem, maps, w


def dense(mem, maps, name, bsz, t):
    base, dims, strides = maps[name]
    idx = np.indices(dims[::-1]).reshape(len(dims), -1)[::-1]
    addr = base + idx[0] + sum(idx[k] * strides[k - 1]
                               for k in range(1, len(dims)))
    return mem[addr].reshape(dims[::-1])


def test_tma_boxes_read_zamba2_slices_in_place():
    """zamba2-1.2b's widths: xBC is 4224 bf16 wide, B at +8192 bytes, C at
    +8320; the x box of (b, h, chunk) holds x[b, t0:t0+Q, h] and the B / C
    boxes B / C[b, t0:t0+Q], rows past T zero (a ragged T, and a slice
    [:, cut:] that must not read past its own T)."""
    rng = np.random.RandomState(1)
    bsz, t, h = 2, 300, 64
    mem, maps, w = projection(rng, bsz, t, h)
    assert w == 4224 and maps["b"][0] * 2 == 8192 and maps["c"][0] * 2 == 8320
    full = {k: dense(mem, maps, k, bsz, t) for k in maps}
    cut = 170
    for name, (base, dims, strides) in maps.items():
        # the slice [:, cut:]: its base moves cut rows, T shrinks, strides
        # stay
        sliced = (base + cut * w, dims[:-2] + (t - cut, bsz), strides)
        for (bb, mp, t0), hh in itertools.product(
                ((0, maps[name], 256), (1, sliced, 0), (1, sliced, 128)),
                (0, h - 1)):
            smem = np.full(TILE // 2, np.nan, np.float32)
            coord = (0, hh, t0, bb) if name == "x" else (0, t0, bb)
            tma_load(smem, 0, mem, *mp, coord)
            got = read_kmajor(smem, 2, 0, Q, 64)
            src = full[name][bb, :, hh] if name == "x" else full[name][bb]
            lo = t0 + (cut if mp is sliced else 0)
            want = np.zeros((Q, 64), np.float32)
            n = min(Q, t - lo)
            want[:n] = src[lo:lo + n]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t0,wg", [(0, 0), (0, 1), (128, 1), (128, 0)])
def test_y_stores_write_rows_below_t_once(t0, wg):
    """Each warpgroup's 64 x P tile lands at its rows of (b, h), every
    element once, and nothing at or past T (T = 200: the second chunk's
    first warpgroup is ragged, its second has no row)."""
    out = np.zeros((2, 200, 3, P), np.float32)
    tile = np.arange(1, 64 * P + 1, dtype=np.float32).reshape(64, P)
    store_y(out, tile, 1, 2, t0, wg)
    r0 = t0 + 64 * wg
    n = max(0, min(64, 200 - r0))
    assert np.count_nonzero(out) == n * P
    np.testing.assert_array_equal(out[1, r0:r0 + n, 2], tile[:n])


# ---------------------------------------------------------------------------
# the wrapper's TMA rule
# ---------------------------------------------------------------------------

def zamba_slices(xbc, h):
    """mamba_block's slices of the convolved projection."""
    xs, b, c = torch.split(xbc, [h * P, N, N], dim=-1)
    return xs.reshape(*xs.shape[:2], h, P), b, c


def rule(name, a):
    return tma_strides(name, a.shape, a.stride(), a.element_size(),
                       a.data_ptr())


def test_tma_rule_takes_zamba2_slices_and_chip_smokes_split():
    """x, B and C as mamba_block slices them at zamba2-1.2b's widths (B at
    +8192 bytes, C at +8320), their [:, cut:] slices (the split case of
    chip_smoke.py), and a batch of one."""
    h = 64
    xbc = torch.zeros((2, 40, h * P + 2 * N), dtype=torch.bfloat16)
    assert xbc.data_ptr() % 16 == 0
    x, b, c = zamba_slices(xbc, h)
    assert b.data_ptr() - xbc.data_ptr() == 8192
    assert c.data_ptr() - xbc.data_ptr() == 8320
    for name, a in (("x", x), ("b", b), ("c", c)):
        assert rule(name, a) == (a.stride(0), a.stride(1))
        for cut in (13, 20):
            assert rule(name, a[:, cut:]) == (a.stride(0), a.stride(1))
        one = a[:1, :1]
        assert rule(name, one) == (math.prod(one.shape[2:]),) * 2


@pytest.mark.parametrize("how", ["shifted", "odd width", "odd batch"])
def test_tma_rule_refuses_what_the_tma_cannot_read(how):
    h = 2
    if how == "shifted":       # a slice one column on: base + 2 bytes
        xbc = torch.zeros((2, 8, h * P + 2 * N + 1), dtype=torch.bfloat16)
        x, b, c = zamba_slices(xbc[..., 1:], h)
        names = ("x", "b", "c")
        msg = "base address"
    elif how == "odd width":   # rows of 4 bytes more than 16 a row
        xbc = torch.zeros((2, 8, h * P + 2 * N + 2), dtype=torch.bfloat16)
        x, b, c = zamba_slices(xbc[..., :h * P + 2 * N], h)
        names = ("x",)
        msg = "time stride"
    else:                      # batch rows 1 step apart in a padded buffer
        buf = torch.zeros((2 * 8 + 2, h * P + 2 * N), dtype=torch.bfloat16)
        xbc = torch.as_strided(buf, (2, 8, h * P + 2 * N),
                               (9 * (h * P + 2 * N) + 1, h * P + 2 * N, 1))
        x, b, c = zamba_slices(xbc, h)
        names = ("x",)
        msg = "base address|batch stride"
    for name in names:
        with pytest.raises(ValueError, match=rf"ssd_scan {name}: .*({msg})"):
            rule(name, {"x": x, "b": b, "c": c}[name])


# ---------------------------------------------------------------------------
# the kernel's arithmetic, whole
# ---------------------------------------------------------------------------

def softplus(v):
    return np.logaddexp(np.float32(v), np.float32(0)).astype(np.float32)


def producer(dt_chunk, valid, a2):
    """The producer warp: softplus, the mask after it, lane l's four steps
    summed in order, the warp's inclusive scan (shfl_up steps), L in log2
    units, the rows past T set to L_Q (L of the last row below T),
    cw = ex2(L_Q - L) dt and colf = ex2(L_r - L) dt, r the last row of the
    row's 16-row block."""
    v = np.where(valid, softplus(dt_chunk), np.float32(0)).astype(np.float32)
    la = (v * a2).astype(np.float32).reshape(32, 4)
    loc = np.zeros_like(la)
    run = np.zeros(32, np.float32)
    for e in range(4):
        run = (run + la[:, e]).astype(np.float32)
        loc[:, e] = run
    incl = run.copy()
    off = 1
    while off < 32:
        sh = np.concatenate([np.zeros(off, np.float32), incl[:-off]])
        incl = np.where(np.arange(32) >= off, incl + sh, incl).astype(
            np.float32)
        off *= 2
    excl = np.concatenate([np.zeros(1, np.float32), incl[:-1]])
    lc = (loc + excl[:, None]).astype(np.float32).reshape(-1)
    last = np.flatnonzero(valid)[-1]
    lc[last + 1:] = lc[last]          # rows past T take L_Q exactly
    cw = (np.exp2(lc[-1] - lc) * v).astype(np.float32)
    colf = (np.exp2(lc[np.arange(Q) | 15] - lc) * v).astype(np.float32)
    return lc, v, cw, colf


def write_h(smem, plan, hr):
    """WG0's write of h (fp32, accumulator layout [p][n]) as its bf16 pair,
    K-major, thread by thread."""
    hi, lo = split(hr)
    rows, cols = ACC64[..., 0].ravel(), ACC64[..., 1].ravel()
    off = sw128(rows * 128 + cols * 2)
    smem[(plan["hhi"] + off) // 2] = hi[rows, cols]
    smem[(plan["hlo"] + off) // 2] = lo[rows, cols]


def make_m(sc, lc, v, colf, rows):
    """make_m on a warpgroup's S [64, ns]: below the row's diagonal 16-block
    (S exp(L_t - L_r)) colf_s with r the block's last row, in it S
    exp(L_t - L_s) dt_s where s <= t (selected: exp may overflow above the
    diagonal), zeros above it."""
    ns = sc.shape[1]
    s_idx = np.arange(ns)
    blk, cd = s_idx[None] // 16, rows[:, None] // 16
    with np.errstate(over="ignore", invalid="ignore"):
        rf = np.exp2(lc[rows][:, None] - lc[(s_idx | 15)][None])
        below = (sc * rf).astype(np.float32) * colf[None, :ns]
        e = np.exp2(lc[rows][:, None] - lc[None, :ns])
        diag = np.where(s_idx[None] <= rows[:, None],
                        (sc * e).astype(np.float32) * v[None, :ns], 0)
        m = np.where(blk < cd, below, np.where(blk == cd, diag, 0))
    m = m.astype(np.float32)
    assert np.isfinite(m).all()
    return m


def model_ssd(mem, maps, dt, a_log, d_skip, h0, bsz, t, h, m_split=True):
    """ssd.cu's kernel, block by block and chunk by chunk (see the module
    docstring).  ``m_split=False``: M rounded once to bf16 (no lo term)."""
    plan = smem_plan()
    out = np.full((bsz, t, h, P), np.nan, np.float32)
    h_t = np.zeros((bsz, h, P, N), np.float32)
    chunks = -(-t // Q)
    for blk in range(bsz * h):
        b, hh = divmod(blk, h)
        smem = np.full(plan["arr0"] // 2, np.nan, np.float32)
        a2 = np.float32(-np.exp(np.float32(a_log[hh]))) * LOG2E
        hr = (h0[b, hh] if h0 is not None
              else np.zeros((P, N))).astype(np.float32)
        write_h(smem, plan, hr)
        for c in range(chunks):
            st, t0 = c % STAGES, c * Q
            xs, bs, cs = (plan[f"{k}{st}"] for k in "xbc")
            tt = t0 + np.arange(Q)
            lc, v, cw, colf = producer(dt[b, np.minimum(tt, t - 1), hh], tt < t,
                                       a2)
            tma_load(smem, xs, mem, *maps["x"], (0, hh, t0, b))
            tma_load(smem, bs, mem, *maps["b"], (0, t0, b))
            tma_load(smem, cs, mem, *maps["c"], (0, t0, b))
            for wg in range(2):
                ns, rows = 64 * (wg + 1), 64 * wg + np.arange(64)
                sc = np.zeros((64, ns), np.float32)
                y = np.zeros((64, P), np.float32)
                for kk in range(N // 16):
                    ck = read_kmajor(smem, 2, cs + wg * 64 * 128 + kk * 32,
                                     64, 16)
                    sc += ck @ read_kmajor(smem, 2, bs + kk * 32, ns, 16).T
                    for part in ("hhi", "hlo"):
                        y += ck @ read_kmajor(smem, 2, plan[part] + kk * 32,
                                              P, 16).T
                m = make_m(sc, lc, v, colf, rows)
                mh, ml = split(m) if m_split else (bf16(m), 0 * m)
                y *= np.exp2(lc[rows])[:, None]
                for step in range(ns // 16):
                    fx = read_mnmajor(smem, 2, xs + step * 2048, P, 16,
                                      lbo=TILE)
                    for part in (mh, ml):
                        y += a_fragment(part, step) @ fx.T
                xv = read_kmajor(smem, 2, xs + wg * 64 * 128, 64, 64)
                y = (y + np.float32(d_skip[hh]) * xv).astype(np.float32)
                store_y(out, y, b, hh, t0, wg)
            # the state: cw .* B as its pair in B's layout, x^T M-major
            s_, n_ = np.meshgrid(np.arange(Q), np.arange(N), indexing="ij")
            off = sw128(s_ * 128 + n_ * 2)
            hi, lo = split(smem[(bs + off) // 2] * cw[:, None])
            smem[(plan["cwhi"] + off) // 2] = hi
            smem[(plan["cwlo"] + off) // 2] = lo
            hr = (hr * np.exp2(lc[-1])).astype(np.float32)
            for kk in range(Q // 16):
                xa = read_mnmajor(smem, 2, xs + kk * 2048, P, 16, lbo=TILE)
                for part in ("cwhi", "cwlo"):
                    hr += xa @ read_mnmajor(smem, 2, plan[part] + kk * 2048,
                                            N, 16, lbo=TILE).T
            if c + 1 < chunks:
                write_h(smem, plan, hr)
        h_t[b, hh] = hr
    return out, h_t


CASES = {  # name: (B, T, H, dt scale, dt shift, h0)
    "ragged": (2, 300, 2, 1.0, 0.0, False),
    "h0": (1, 256, 2, 1.0, 0.0, True),
    # softplus(dt) ~ 6.25: dt a ~ -100 a step at a = -16, exp(L_t - L_s)
    # overflows above the diagonal
    "strong decay": (1, 200, 2, 0.2, 6.25, True),
}


def case_inputs(name):
    bsz, t, h, scale, shift, with_h0 = CASES[name]
    rng = np.random.RandomState(len(name))
    mem, maps, _ = projection(rng, bsz, t, h)
    dt = bf16(rng.randn(bsz, t, h).astype(np.float32) * scale + shift)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    d_skip = np.ones(h, np.float32)
    h0 = rng.randn(bsz, h, P, N).astype(np.float32) if with_h0 else None
    return mem, maps, dt, a_log, d_skip, h0, bsz, t, h


def reference(mem, maps, dt, a_log, d_skip, h0, bsz, t, h):
    x, b, c = (torch.tensor(dense(mem, maps, k, bsz, t)) for k in "xbc")
    return ref_ssd(x, torch.tensor(dt), torch.tensor(a_log), b, c,
                   torch.tensor(d_skip),
                   h0=None if h0 is None else torch.tensor(h0),
                   return_state=True)


def rel(got, want):
    want = want.numpy().astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_ref_ssd(name):
    args = case_inputs(name)
    y, h_t = model_ssd(*args)
    want_y, want_h = reference(*args)
    assert np.isfinite(y).all() and np.isfinite(h_t).all()
    assert rel(y, want_y) <= REL and rel(h_t, want_h) <= REL, (
        rel(y, want_y), rel(h_t, want_h))


def test_one_bf16_rounding_of_m_misses_the_limit():
    """The counter-case: without M's lo term the same model misses 1e-4."""
    args = case_inputs("ragged")
    y, _ = model_ssd(*args, m_split=False)
    want_y, _ = reference(*args)
    assert rel(y, want_y) > REL


def test_dt_mask_after_the_softplus():
    """A zero-filled dt row is softplus(0) = ln 2, not 0: unmasked, the
    padded rows would decay L and, through exp(L_Q) and cw, change h."""
    a2 = np.float32(-16.0) * LOG2E
    raw = np.zeros(Q, np.float32)
    valid = np.arange(Q) < 44
    lc, v, cw, colf = producer(raw, valid, a2)
    assert (v[~valid] == 0).all() and (cw[~valid] == 0).all()
    assert (colf[~valid] == 0).all() and lc[-1] == lc[43]
    lc2, v2, _, _ = producer(raw, np.ones(Q, bool), a2)
    assert np.isclose(v2[50], np.log(2)) and lc2[-1] < lc[-1]
