"""``topk_positions``' Hopper kernel (``csrc/topk_gating.cu``), the part
the CPU can reach: a numpy model of its work split and its arithmetic.

The model follows the kernel.  Up to 1,024 entries, one CTA of ceil(n /
32) warps, thread x summing expert x's per-warp counts in warp order.
Past that, one thread-block cluster of G CTAs, each owning ``span``
contiguous chunks of 1,024 entries of the choice-major flat order f =
choice * T + token (G and span from n and the largest cluster, 16 or 8,
as ``positions_plan`` picks them); a chunk as 32 warps
whose ``__match_any_sync`` groups give each entry its rank among the equal
experts of lower lanes; the lowest lane of a group writing the group's
count to its warp's row of a [32, kPosRow] table that is zeroed once a
CTA; one warp an expert scanning its 32 counts with ``__shfl_up_sync``
steps, a positive entry counting and anything else counting 0, and writing
back each warp's offset complemented; spans of up to kPosHeld chunks
ranked in one pass (the CTA's counts the scan's running totals), longer
ones counted first and ranked in a second walk; and each CTA's base per
expert, the counts of the ranks below it added in rank order.

It is held bitwise to ``ref_topk_positions`` (the port's and the
reference's) and to the reference's Pallas kernel in interpret mode, over
n from 1 to past 16 chunks, k 1-4, E 1-256, all masked, all one expert and
ids past E, at both cluster limits.  Two counter-cases (offsets written
back uncomplemented, so that the table's stale entries count; a base that
adds the CTA's own counts) miss the reference.  The model reads its
constants from the source; the kernel itself runs only on the card
(``chip_smoke.py`` phase 1).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.topk_gating import topk_positions as j_positions
from repro_torch.kernels import ref
from repro_torch.kernels.topk_gating import (MAX_POS_ENTRIES,
                                             MAX_POS_EXPERTS)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SOURCE = (CSRC / "topk_gating.cu").read_text()


def constant(name: str) -> int:
    """The integer literal a ``constexpr int`` of the source is set to."""
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", SOURCE)
    assert len(found) == 1, f"{name} set {len(found)}x"
    return int(found[0])


CHUNK = constant("kPosThreads")          # entries a chunk: one a thread
WARPS = CHUNK // 32
ROW = constant("kPosRow")
MAX_E = constant("kPosMaxE")
MAX_CLUSTER = constant("kPosMaxCluster")
PORTABLE = constant("kPosPortableCluster")
HELD = constant("kPosHeld")
LANE_PAD = 128                 # the Pallas kernel's one-hot width unit
LOWER = np.tri(32, 32, -1, dtype=bool)   # [lane, other]: other < lane


def plan(n: int, gmax: int):
    """topk_positions_plan: (G, span, walk)."""
    if n <= CHUNK:
        return 1, 1, "one CTA"
    chunks = -(-n // CHUNK)
    span = -(-chunks // gmax)
    return (-(-chunks // span), span,
            "one pass" if span <= HELD else "second walk")


def entries(idx, e: int, f0: int, f1: int, j: int):
    """Chunk j of the span [f0, f1): each thread's expert (-1 masked, past
    E or past f1) and its index t * k + c into idx and pos."""
    t_, k = idx.shape
    f = f0 + j * CHUNK + np.arange(CHUNK)
    ok = f < f1
    c = f // t_
    at = np.where(ok, (f - c * t_) * k + c, 0)
    ex = np.where(ok, idx.reshape(-1)[at], -1)
    return np.where((ex >= 0) & (ex < e), ex, -1), at, ok


def match_any(ex):
    """Per thread: the lanes of its warp below it with its expert, and its
    group's size (``__match_any_sync`` and two ``__popc``)."""
    w = ex.reshape(-1, 32)
    eq = w[:, :, None] == w[:, None, :]
    return (eq & LOWER).sum(-1), eq.sum(-1)


def solo(idx, e: int):
    """positions_solo_kernel, n <= 1024: ceil(n / 32) warps, each leader's
    count in its warp's row, thread x summing expert x's rows in order."""
    t_, k = idx.shape
    n = t_ * k
    nw = -(-n // 32)
    ex, at, ok = entries(idx, e, 0, n, 0)
    ex, at, ok = ex[:nw * 32], at[:nw * 32], ok[:nw * 32]
    below, size = match_any(ex)
    w = ex.reshape(nw, 32)
    tab = np.zeros((nw, e), np.int64)
    lead = (w >= 0) & (below == 0)
    wi, li = np.nonzero(lead)
    tab[wi, w[wi, li]] = size[wi, li]
    run = np.zeros(e, np.int64)
    for r in range(nw):                  # thread x: the rows in order
        tab[r], run = run.copy(), run + tab[r]
    warp = np.repeat(np.arange(nw), 32)
    val = np.where(ex >= 0, tab[warp, np.maximum(ex, 0)] + below.reshape(-1),
                   0)
    out = np.full(n, -7, np.int64)
    out[at[ok]] = val[ok]
    assert (out != -7).all()
    return out.reshape(t_, k)


def shfl_scan(v):
    """The inclusive scan over the 32 lanes (axis 0) by __shfl_up_sync
    steps of 1, 2, 4, 8, 16."""
    incl = v.copy()
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(incl)
        up[d:] = incl[:-d]
        incl = incl + up
    return incl


def rank_chunk(tab, run, ex, e: int, complement: bool = True):
    """rank_chunk: each entry's rank in the chunk plus run[expert]; adds
    the chunk's counts to run.  ``complement`` False writes the offsets
    back as they are (the counter-case)."""
    below, size = match_any(ex)
    w = ex.reshape(WARPS, 32)
    lead = (w >= 0) & (below == 0)
    wi, li = np.nonzero(lead)
    tab[wi, w[wi, li]] = size[wi, li]
    v = tab[:, :e]                      # lane w reads row w
    cnt = np.where(v > 0, v, 0)
    incl = shfl_scan(cnt)
    off = run[None, :] + incl - cnt
    tab[:, :e] = ~off if complement else off
    run += incl[-1]
    warp = np.repeat(np.arange(WARPS), 32)
    got = tab[warp, np.maximum(ex, 0)]
    got = ~got if complement else got
    return np.where(ex >= 0, got + below.reshape(-1), 0)


def model(idx, e: int, gmax: int, complement: bool = True,
          own_base: bool = False):
    """The kernel's positions for idx [T, k] at clusters of up to gmax
    CTAs.  ``own_base`` adds each CTA's own counts to its base (the other
    counter-case)."""
    t_, k = idx.shape
    n = t_ * k
    g, span, walk = plan(n, gmax)
    if walk == "one CTA":
        return solo(idx, e)
    one_pass = walk == "one pass"
    out = np.full(n, -7, np.int64)     # every entry is written once
    counts, held = [], []
    for r in range(g):                 # up to the cluster barrier
        f0 = r * span * CHUNK
        f1 = min(n, f0 + span * CHUNK)
        tab = np.zeros((WARPS, ROW), np.int64)
        cnt = np.zeros(e, np.int64)
        if one_pass:
            chunks = [entries(idx, e, f0, f1, j) for j in range(span)]
            locs = [rank_chunk(tab, cnt, ex, e, complement)
                    for ex, _, _ in chunks]
            held.append((chunks, locs))
        else:
            for j in range(span):
                ex, _, _ = entries(idx, e, f0, f1, j)
                below, size = match_any(ex)
                lead = (ex >= 0) & (below.reshape(-1) == 0)
                np.add.at(cnt, ex[lead], size.reshape(-1)[lead])
            held.append((tab, f0, f1))
        counts.append(cnt)
    for r in range(g):                 # after it
        base = np.zeros(e, np.int64)
        for q in range(r + 1 if own_base else r):
            base += counts[q]          # rank order
        if one_pass:
            chunks, locs = held[r]
            for (ex, at, ok), loc in zip(chunks, locs):
                val = np.where(ex >= 0, base[np.maximum(ex, 0)] + loc, 0)
                assert (out[at[ok]] == -7).all()
                out[at[ok]] = val[ok]
        else:
            tab, f0, f1 = held[r]
            run = base
            for j in range(span):
                ex, at, ok = entries(idx, e, f0, f1, j)
                p = rank_chunk(tab, run, ex, e, complement)
                assert (out[at[ok]] == -7).all()
                out[at[ok]] = p[ok]
    assert (out != -7).all()
    return out.reshape(t_, k)


def make_ids(t_: int, k: int, e: int, kind: str, seed: int):
    rng = np.random.RandomState(seed)
    if kind == "masked":
        return np.full((t_, k), -1, np.int32)
    if kind == "one":
        return np.full((t_, k), e // 2, np.int32)
    ids = rng.randint(-1, e, (t_, k))
    if kind == "past":
        pad = -(-e // LANE_PAD) * LANE_PAD
        far = rng.choice([e, e + 1, pad, pad + 5, 1000, 2 ** 31 - 1],
                         (t_, k))
        ids = np.where(rng.rand(t_, k) < 0.3, far, ids)
    return ids.astype(np.int32)


# (T, k, E, kind): one entry; ragged small ones; one chunk exactly; a span
# boundary inside a choice (T 1025: chunk 1 starts at token 1024 of choice
# 0); gpt2-moe training (16 chunks); llama4's width; E 256 at 20 chunks (two
# a CTA at 16, a second walk at 8); all masked, all one expert and ids past
# E; and 40 chunks (a second walk at both limits)
CASES = [(1, 1, 8, "rand"), (7, 3, 16, "rand"), (1000, 1, 1, "rand"),
         (1024, 1, 8, "rand"), (1025, 2, 16, "rand"), (700, 4, 16, "rand"),
         (8192, 2, 16, "rand"), (2048, 1, 128, "rand"),
         (5000, 4, 256, "rand"), (9000, 2, 16, "masked"),
         (9000, 2, 16, "one"), (6000, 3, 16, "past"), (3000, 2, 256, "past"),
         (40000, 1, 8, "rand")]


@pytest.mark.parametrize("t_,k,e,kind", CASES,
                         ids=[f"{t}x{k}-e{e}-{kind}" for t, k, e, kind
                              in CASES])
def test_model_matches_plain_and_pallas(t_, k, e, kind):
    ids = make_ids(t_, k, e, kind, seed=t_ * 7 + k + e)
    want = ref.ref_topk_positions(torch.from_numpy(ids), e).numpy()
    np.testing.assert_array_equal(
        np.asarray(jref.ref_topk_positions(jnp.asarray(ids), e)), want)
    # the Pallas kernel's one-hot spans its 128-lane padding, so it ranks
    # ids in [E, pad) that the contract masks: it gets those as -1
    pad = -(-e // LANE_PAD) * LANE_PAD
    lanes = np.where((ids >= e) & (ids < pad), -1, ids).astype(np.int32)
    kern = np.asarray(j_positions(jnp.asarray(lanes), e, interpret=True))
    np.testing.assert_array_equal(kern, want)
    for gmax in (MAX_CLUSTER, PORTABLE):
        np.testing.assert_array_equal(model(ids, e, gmax), want)


def test_plan_gives_every_cta_a_chunk():
    assert (CHUNK, MAX_E, MAX_CLUSTER, PORTABLE, HELD) == (1024, 256, 16, 8,
                                                           2)
    assert MAX_E == MAX_POS_EXPERTS
    assert int(re.search(r"kPosMaxEntries\s*=\s*1\s*<<\s*(\d+)",
                         SOURCE)[1]) == MAX_POS_ENTRIES.bit_length() - 1
    for gmax in (MAX_CLUSTER, PORTABLE):
        for n in list(range(1, 3 * CHUNK, 97)) + list(
                range(CHUNK, 80 * CHUNK, 333)):
            g, span, walk = plan(n, gmax)
            chunks = -(-n // CHUNK)
            assert 1 <= g <= gmax and (g - 1) * span < chunks <= g * span
            assert (walk == "one CTA") == (n <= CHUNK)
            if n > CHUNK:      # a cluster: two CTAs or more
                assert g >= 2 and (walk == "one pass") == (span <= HELD)
    # gpt2-moe training, 8192 x 2: 16 CTAs of one chunk (8 of two); the
    # 65,536-entry case walks twice at either limit
    assert plan(16384, MAX_CLUSTER) == (16, 1, "one pass")
    assert plan(16384, PORTABLE) == (8, 2, "one pass")
    assert plan(65536, MAX_CLUSTER) == (16, 4, "second walk")
    assert plan(65536, PORTABLE) == (8, 8, "second walk")
    assert plan(256, MAX_CLUSTER) == (1, 1, "one CTA")   # serve prefill
    assert plan(1025, MAX_CLUSTER) == (2, 1, "one pass")


def test_scan_reads_hit_every_bank_once():
    """Lane w reads row w of column x: 32 banks apart for every x."""
    for x in range(MAX_E):
        banks = (np.arange(32) * ROW + x) % 32
        assert len(set(banks.tolist())) == 32
    assert WARPS * ROW * 4 + 2 * MAX_E * 4 <= 48 * 1024   # static smem


@pytest.mark.parametrize("wrong", ["uncomplemented", "own base"])
def test_counter_cases_miss_the_reference(wrong):
    """Offsets written back as they are make stale entries count in the
    next chunk's scan; a base with the CTA's own counts shifts every rank
    past rank 0.  Both miss the reference; the kernel's choices do not."""
    ids = make_ids(5000, 2, 16, "rand", seed=5)
    want = ref.ref_topk_positions(torch.from_numpy(ids), 16).numpy()
    np.testing.assert_array_equal(model(ids, 16, PORTABLE), want)
    kw = ({"complement": False} if wrong == "uncomplemented"
          else {"own_base": True})
    assert not np.array_equal(model(ids, 16, PORTABLE, **kw), want)
