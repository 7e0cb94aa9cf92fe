"""``dispatch_rows``' Hopper kernel (``csrc/dispatch.cu``) and its ``dot=``
operand, the parts the CPU can reach.

* A numpy model of the kernel's layout and arithmetic: warp r %
  kRowWarps of block r // kRowWarps owns slot row r; lane l moves 16-byte
  vectors l, l + 32, ... of 8 bf16, loading kVec of them (and as many of
  the dot row) before its first store; the scaled product rounded to fp32,
  then to nearest bf16; an empty row zeroed; rowdot as 8 fp32 partials a
  lane in vector order, added pairwise, then a shuffle butterfly over the
  32 lanes.  Its out is bitwise ``ref_dispatch_rows``' and its rowdot
  within 1e-5 of sum |dot * x| of the plain version's (the limit
  ``chip_smoke.py`` phase 1 holds the kernel to).  The model reads its
  constants from the source.
* ``vector_rule``, the 16-byte rule both row movers' wrappers apply.
* ``ref_dispatch_rows(..., dot=)`` and ``_Combine.backward`` (which takes
  the gate weights' gradient from the dispatch pass's rowdot) against
  ``jax.grad`` of the reference's combine, with ``use_pallas`` True (its
  custom VJP, interpret mode) and False (autodiff of its oracle): k 1 and
  2, dropped choices, every choice dropped, empty slots.  d buf exact, d
  weights within atol = rtol = 1e-5 (fp32 sums in another order).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dispatch import dispatch_rows, vector_rule

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
DISPATCH = (CSRC / "dispatch.cu").read_text()
DOT_REL = 1e-5


def constant(name: str) -> int:
    """The integer literal a ``constexpr int`` of dispatch.cu is set to."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)", DISPATCH)
    assert len(found) == 1, f"{name} set {len(found)}x"
    return int(found[0])


ROW_WARPS, VEC = constant("kRowWarps"), constant("kVec")


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


# ---------------------------------------------------------------------------
# the numpy model of dispatch_kernel
# ---------------------------------------------------------------------------

def model_dispatch(x, src, scale=None, dot=None):
    """csrc/dispatch.cu::dispatch_kernel on bf16-valued float32 arrays.
    Returns (out, rowdot or None, the (block, warp) owning each row, the
    vectors each (row, lane) stored, the loads each (row, lane) had in
    flight at once)."""
    n_src, d = x.shape
    n_rows = src.shape[0]
    dv = d // 8
    f32 = np.float32
    out = np.full((n_rows, d), np.nan, np.float32)
    rowdot = None if dot is None else np.full(n_rows, np.nan, np.float32)
    owner, stored, flight = {}, {}, {}
    for r in range(n_rows):
        owner[r] = (r // ROW_WARPS, r % ROW_WARPS)
        s = int(src[r])
        if s < 0 or s >= n_src:
            for lane in range(32):
                stored[(r, lane)] = list(range(lane, dv, 32))
                flight[(r, lane)] = 0
                for c in stored[(r, lane)]:
                    out[r, 8 * c:8 * c + 8] = 0.0
            if dot is not None:
                rowdot[r] = 0.0
            continue
        sc = f32(1.0 if scale is None else scale[r])
        partial = np.zeros(32, f32)
        for lane in range(32):
            acc = np.zeros(8, f32)
            seq, most = [], 0
            for c0 in range(lane, dv, 32 * VEC):
                vs = [c0 + 32 * u for u in range(VEC) if c0 + 32 * u < dv]
                v = {c: x[s, 8 * c:8 * c + 8].astype(f32) for c in vs}
                w = {} if dot is None else \
                    {c: dot[r, 8 * c:8 * c + 8].astype(f32) for c in vs}
                most = max(most, len(v) + len(w))
                for c in vs:                     # in vector order
                    out[r, 8 * c:8 * c + 8] = v[c] if scale is None \
                        else bf16((v[c] * sc).astype(f32))
                    if dot is not None:
                        acc = (acc + (w[c] * v[c]).astype(f32)).astype(f32)
                    seq.append(c)
            stored[(r, lane)], flight[(r, lane)] = seq, most
            a = acc
            partial[lane] = f32(f32(f32(a[0] + a[1]) + f32(a[2] + a[3]))
                                + f32(f32(a[4] + a[5]) + f32(a[6] + a[7])))
        m = 16
        while m:                                 # __shfl_xor_sync butterfly
            partial = (partial + partial[np.arange(32) ^ m]).astype(f32)
            m >>= 1
        if dot is not None:
            assert np.all(partial == partial[0])  # every lane agrees
            rowdot[r] = partial[0]
    return out, rowdot, owner, stored, flight


def _case(seed, n_src, n_rows, d):
    rng = np.random.RandomState(seed)
    x = bf16(rng.randn(n_src, d))
    src = rng.randint(-1, n_src, n_rows).astype(np.int32)
    src[:2] = -1                                 # empty slots
    src[2] = n_src                               # out of range: empty
    scale = rng.rand(n_rows).astype(np.float32)
    dot = bf16(rng.randn(n_rows, d))
    return x, src, scale, dot


def _plain(x, src, scale=None, dot=None):
    clip = np.where(src < x.shape[0], src, -1).astype(np.int32)
    got = ref.ref_dispatch_rows(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(clip),
        None if scale is None else torch.from_numpy(scale),
        dot=None if dot is None else torch.from_numpy(dot).bfloat16())
    if dot is None:
        return got.float().numpy(), None
    return got[0].float().numpy(), got[1].numpy()


@pytest.mark.parametrize("mode", ["copy", "scaled", "dot"])
@pytest.mark.parametrize("d", [768, 776, 64, 8, 2048])
def test_model_matches_plain_bitwise(d, mode):
    x, src, scale, dot = _case(d, 7, 11, d)
    sc = None if mode == "copy" else scale
    dt = dot if mode == "dot" else None
    got, rowdot, owner, stored, flight = model_dispatch(x, src, sc, dt)
    want, want_dot = _plain(x, src, sc, dt)
    np.testing.assert_array_equal(got, want)     # bitwise, empty rows 0
    dv = d // 8
    for r in range(len(src)):
        vecs = sorted(c for lane in range(32) for c in stored[(r, lane)])
        assert vecs == list(range(dv))           # each vector once
    if dt is None:
        return
    kept = (src >= 0) & (src < x.shape[0])
    assert np.all(rowdot[~kept] == 0.0)
    s = np.where(kept, src, 0)
    mag = np.abs(dot.astype(np.float64) * x[s].astype(np.float64)).sum(-1)
    assert np.all(np.abs(rowdot - want_dot)[kept] <= DOT_REL * mag[kept])
    exact = (dot.astype(np.float64) * x[s].astype(np.float64)).sum(-1)
    assert np.all(np.abs(rowdot - exact)[kept] <= DOT_REL * mag[kept])


def test_model_layout_fills_the_card_and_keeps_loads_in_flight():
    x, src, scale, dot = _case(0, 6, 9, 768)
    src[3:] = np.arange(6)
    _, _, owner, _, flight = model_dispatch(x, src, scale, dot)
    assert sorted(owner.values()) == sorted(
        {(r // ROW_WARPS, r % ROW_WARPS) for r in range(len(src))})
    # at D 768 each lane has its 3 vectors of x and 3 of the dot row in
    # flight before its first store
    assert all(flight[(r, lane)] == 6 for r in range(3, 9)
               for lane in range(32))
    assert ROW_WARPS * 32 <= 1024
    # decode's 512 slot rows already span nearly every SM of 132
    assert 120 <= -(-512 // ROW_WARPS) <= 2 * 132


def test_rowdot_of_cancelling_rows_stays_within_the_limit():
    """Products that cancel: the limit is relative to sum |dot * x|, not
    to the (near zero) dot itself."""
    rng = np.random.RandomState(9)
    d = 768
    x = bf16(rng.randn(3, d))
    dot = np.concatenate([x[:1], -x[:1], bf16(rng.randn(1, d) * 1e3)])
    src = np.array([0, 0, 2], np.int32)
    _, rowdot, *_ = model_dispatch(x, src, None, dot)
    _, want_dot = _plain(x, src, None, dot)
    mag = np.abs(dot * x[src]).astype(np.float64).sum(-1)
    assert np.all(np.abs(rowdot - want_dot) <= DOT_REL * mag)
    assert rowdot[0] == -rowdot[1] and rowdot[0] > 0


# ---------------------------------------------------------------------------
# the 16-byte rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,offset", [(768, 0), (8, 16), (6144, 4096)])
def test_vector_rule_takes_whole_aligned_vectors(d, offset):
    vector_rule("dispatch_rows x", d, 1 << 20 | offset)


@pytest.mark.parametrize("d,offset,what", [
    (770, 0, r"D \(770\) must be a multiple of 8"),
    (4, 0, r"D \(4\)"),
    (768, 2, r"\(offset 2\)"),
    (768, 8, r"\(offset 8\)")])
def test_vector_rule_refuses(d, offset, what):
    with pytest.raises(ValueError, match="dispatch_rows dot moves 16-byte "
                       "vectors: .*" + what):
        vector_rule("dispatch_rows dot", d, 1 << 20 | offset)


def test_a_row_slice_of_a_bf16_buffer_keeps_the_rule():
    """A bf16 buffer sliced by whole rows of D = 8 n stays aligned; one
    sliced by a column does not."""
    buf = torch.zeros(6, 16, dtype=torch.bfloat16)
    vector_rule("combine_rows buf", 16, buf[2:].data_ptr()
                - buf.data_ptr())
    with pytest.raises(ValueError, match="offset 2"):
        vector_rule("combine_rows buf", 16, buf.reshape(-1)[1:].data_ptr()
                    - buf.data_ptr())


# ---------------------------------------------------------------------------
# ref_dispatch_rows(dot=) and the combine backward against the reference
# ---------------------------------------------------------------------------

def _rows(rng, tt, k, n_rows, n_drop):
    """[T, k] distinct destination rows, ``n_drop`` choices dropped; slot 0
    is kept unless every choice is dropped (a dropped choice's gather is
    clamped to row 0, so its weight gradient must be masked)."""
    rows = np.concatenate([[0], 1 + rng.permutation(n_rows - 1)[:tt * k - 1]])
    drop = rng.choice(np.arange(1, tt * k), min(n_drop, tt * k - 1),
                      replace=False)
    rows[drop] = -1
    if n_drop >= tt * k:
        rows[:] = -1
    return rows.reshape(tt, k).astype(np.int32)


@pytest.mark.parametrize("k,n_drop", [(1, 0), (1, 4), (2, 0), (2, 5),
                                      (2, 26)],
                         ids=["k1", "k1-drop", "k2", "k2-drop", "k2-all"])
def test_combine_backward_takes_dw_from_rowdot(k, n_drop, monkeypatch):
    rng = np.random.RandomState(k * 10 + n_drop)
    tt, d, n_rows = 13, 24, 40                   # 40 - 13 k slots empty
    rows = _rows(rng, tt, k, n_rows, n_drop)
    buf = rng.randn(n_rows, d).astype(np.float32)
    w = rng.rand(tt, k).astype(np.float32)
    cy = rng.randn(tt, d).astype(np.float32)

    seen = []
    real = ops.dispatch_rows

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(kw.get("dot") is not None)
        return out
    monkeypatch.setattr(ops, "dispatch_rows", spy)
    tb = torch.tensor(buf, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = ops.combine_op(tb, torch.from_numpy(rows), tw)
    gb, gw = torch.autograd.grad((y * torch.from_numpy(cy)).sum(), (tb, tw))
    assert seen == [True]             # one dispatch pass, with dot

    for use_pallas in (True, False):
        _, comb = jops.dispatch_combine_op(use_pallas=use_pallas)
        jb, jw = jax.grad(lambda b_, w_: jnp.sum(
            comb(b_, jnp.asarray(rows), w_) * cy), argnums=(0, 1))(
            jnp.asarray(buf), jnp.asarray(w))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(gw.numpy(), np.asarray(jw), atol=1e-5,
                                   rtol=1e-5)
    if n_drop >= tt * k:
        assert not gw.any() and not gb.any()


@pytest.mark.parametrize("with_scale", [False, True])
def test_plain_dispatch_rowdot_is_the_gathered_dot(with_scale):
    rng = np.random.RandomState(4)
    t, d, r = 9, 16, 21
    x = rng.randn(t, d).astype(np.float32)
    src = rng.randint(-1, t, r).astype(np.int32)
    scale = rng.rand(r).astype(np.float32) if with_scale else None
    dot = rng.randn(r, d).astype(np.float32)
    tsc = None if scale is None else torch.from_numpy(scale)
    out, rowdot = dispatch_rows(torch.from_numpy(x), torch.from_numpy(src),
                                tsc, dot=torch.from_numpy(dot))
    alone = dispatch_rows(torch.from_numpy(x), torch.from_numpy(src), tsc)
    np.testing.assert_array_equal(out.numpy(), alone.numpy())
    want = np.where(src >= 0, np.sum(dot.astype(np.float64)
                                     * x[np.maximum(src, 0)], -1), 0.0)
    np.testing.assert_allclose(rowdot.numpy(), want, atol=1e-5, rtol=1e-5)
    assert rowdot.dtype == torch.float32 and np.all(rowdot.numpy()[src < 0]
                                                    == 0)
