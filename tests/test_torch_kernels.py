"""The port's six serve-path kernels on the CPU: each wrapper's plain
PyTorch version against the JAX oracle (``repro.kernels.ref``) and the
Pallas kernel in interpret mode, on the same numpy inputs.

Integer outputs must match exactly; floats within atol = rtol = 1e-4 at
float32 (XLA and PyTorch sum in different orders).  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dispatch import combine_rows as j_combine
from repro.kernels.dispatch import dispatch_rows as j_dispatch
from repro.kernels.dispatch import invert_slots as j_invert
from repro.kernels.dispatch import weighted_route as j_route
from repro.kernels.moe_ffn import grouped_ffn as j_grouped_ffn
from repro.kernels.topk_gating import topk_gating_fused as j_gating
from repro.kernels.topk_gating import topk_positions as j_positions
from repro_torch.kernels import COUNTERS, ops, reset_counters
from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                          invert_slots, weighted_route)
from repro_torch.kernels.moe_ffn import grouped_ffn
from repro_torch.kernels.topk_gating import topk_gating_fused, topk_positions

TOL = dict(atol=1e-4, rtol=1e-4)


def close(got, *wants):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    for w in wants:
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def exact(got, *wants):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    for w in wants:
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("t", [24, 13])
def test_topk_gating_matches_reference(k, t):
    rng = np.random.RandomState(k + t)
    d, e = 32, 8
    x = rng.randn(t, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    got = topk_gating_fused(torch.from_numpy(x), k,
                            router=torch.from_numpy(router))
    want = jref.ref_topk_gating(jnp.asarray(x) @ jnp.asarray(router), k)
    kern = j_gating(jnp.asarray(x), k, router=jnp.asarray(router),
                    block_t=8, interpret=True)
    exact(got[0], want[0], kern[0])
    close(got[1], want[1], kern[1])
    close(got[2], want[2], kern[2])


def test_topk_gating_ties_take_the_first_max():
    x = np.zeros((3, 4), np.float32)
    x[1, 2] = x[1, 3] = 1.0
    eye = np.eye(4, dtype=np.float32)          # logits == x
    got = topk_gating_fused(torch.from_numpy(x), 2,
                            router=torch.from_numpy(eye))
    kern = j_gating(jnp.asarray(x), 2, router=jnp.asarray(eye),
                    interpret=True)
    exact(got[0], kern[0], [[0, 1], [2, 3], [0, 1]])


@pytest.mark.parametrize("t,k,e", [(16, 1, 4), (37, 2, 8), (9, 2, 3)])
def test_topk_positions_matches_reference(t, k, e):
    rng = np.random.RandomState(t)
    idx = rng.randint(-1, e, (t, k)).astype(np.int32)
    got = topk_positions(torch.from_numpy(idx), e)
    exact(got, jref.ref_topk_positions(jnp.asarray(idx), e),
          j_positions(jnp.asarray(idx), e, block_t=8, interpret=True))


@pytest.mark.parametrize("with_scale", [False, True])
def test_dispatch_rows_matches_reference(with_scale):
    rng = np.random.RandomState(3)
    t, d, r = 20, 16, 33
    x = rng.randn(t, d).astype(np.float32)
    src = rng.randint(-1, t, (r,)).astype(np.int32)
    scale = rng.rand(r).astype(np.float32) if with_scale else None
    got = dispatch_rows(torch.from_numpy(x), torch.from_numpy(src),
                        None if scale is None else torch.from_numpy(scale))
    js = None if scale is None else jnp.asarray(scale)
    close(got, jref.ref_dispatch_rows(jnp.asarray(x), jnp.asarray(src), js),
          j_dispatch(jnp.asarray(x), jnp.asarray(src), js, block_rows=8,
                     block_src=8, interpret=True))


@pytest.mark.parametrize("k", [1, 2])
def test_combine_rows_matches_reference(k):
    rng = np.random.RandomState(k + 10)
    t, d, r = 12, 16, 40
    buf = rng.randn(r, d).astype(np.float32)
    rows = rng.randint(-1, r, (t, k)).astype(np.int32)
    w = rng.rand(t, k).astype(np.float32)
    got = combine_rows(torch.from_numpy(buf), torch.from_numpy(rows),
                       torch.from_numpy(w))
    close(got, jref.ref_combine_rows(jnp.asarray(buf), jnp.asarray(rows),
                                     jnp.asarray(w)),
          j_combine(jnp.asarray(buf), jnp.asarray(rows), jnp.asarray(w),
                    block_t=8, block_rows=8, interpret=True))


def _route_case(seed, t=30, k=2, e=6, rw=4, slot_cap=8):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, e, (t, k)).astype(np.int32)
    pos = np.asarray(jref.ref_topk_positions(jnp.asarray(idx), e))
    w_int = rng.randint(0, slot_cap + 1, (e, rw))
    n_rep = rng.randint(1, rw + 1, (e,))
    slot_of = np.full((e, rw), -1, np.int32)
    for i in range(e):
        w_int[i, n_rep[i]:] = 0
        slot_of[i, :n_rep[i]] = rng.choice(e * rw, n_rep[i], replace=False)
    cum = np.cumsum(w_int, axis=1).astype(np.int32)
    return idx, pos.astype(np.int32), cum, slot_of, slot_cap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_route_matches_reference(seed):
    idx, pos, cum, slot_of, slot_cap = _route_case(seed)
    got = weighted_route(*(torch.from_numpy(a) for a in
                           (idx, pos, cum, slot_of)), slot_cap)
    j = [jnp.asarray(a) for a in (idx, pos, cum, slot_of)]
    exact(got, jref.ref_weighted_route(*j, slot_cap),
          j_route(*j, slot_cap, block_t=8, interpret=True))
    assert (np.asarray(got) >= 0).any() and (np.asarray(got) < 0).any()


def test_invert_slots_matches_reference():
    rows = np.array([[3, -1], [0, 5], [-1, 2], [7, 1]], np.int32)
    got = invert_slots(torch.from_numpy(rows), 8)
    want = j_invert(jnp.asarray(rows), 8)
    exact(got[0], want[0])
    exact(got[1], want[1])


@pytest.mark.parametrize("ffn_type", ["gelu", "swiglu"])
def test_grouped_ffn_matches_reference(ffn_type):
    rng = np.random.RandomState(5)
    g, t, d, f = 3, 16, 32, 64
    x = (rng.randn(g, t, d) * 0.5).astype(np.float32)
    wi = (rng.randn(g, d, f) / np.sqrt(d)).astype(np.float32)
    wu = (rng.randn(g, d, f) / np.sqrt(d)).astype(np.float32)
    wo = (rng.randn(g, f, d) / np.sqrt(f)).astype(np.float32)
    got = grouped_ffn(*(torch.from_numpy(a) for a in (x, wi, wu, wo)),
                      ffn_type=ffn_type)
    j = [jnp.asarray(a) for a in (x, wi, wu, wo)]
    close(got, jref.ref_grouped_ffn(*j, ffn_type),
          j_grouped_ffn(*j, ffn_type=ffn_type, block_t=8, block_f=32,
                        interpret=True))


# (group_expert, group_rows) over 5 groups of 16 rows and 3 experts: a
# slot of -1, a slot with 0 rows, counts that end mid-tile (the Pallas
# kernel's 8-row tile and the Hopper kernel's 128-row one alike)
GROUP_CASES = {
    "index+rows": ([2, 0, -1, 2, 1], [16, 0, 9, 5, 13]),
    "index": ([1, 1, 0, -1, 2], None),
    "rows": (None, [3, 16, 0, 11, 8]),
}


@pytest.mark.parametrize("ffn_type", ["gelu", "swiglu"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouped_ffn_groups_match_reference(ffn_type, case):
    """group_expert reads [E, ...] weights in place, group_rows zeroes the
    rows past each count: held against the interpret-mode Pallas kernel
    fed the gathered weights, with those rows zeroed."""
    ge, gr = GROUP_CASES[case]
    rng = np.random.RandomState(len(case))
    g, t, d, f = 5, 16, 32, 64
    e = 3 if ge is not None else g
    x = (rng.randn(g, t, d) * 0.5).astype(np.float32)
    wi = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    wu = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    wo = (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32)
    tge = None if ge is None else torch.tensor(ge, dtype=torch.int32)
    tgr = None if gr is None else torch.tensor(gr, dtype=torch.int32)
    got = grouped_ffn(*(torch.from_numpy(a) for a in (x, wi, wu, wo)),
                      ffn_type=ffn_type, group_expert=tge, group_rows=tgr)
    sel = np.maximum(ge, 0) if ge is not None else np.arange(g)
    j = [jnp.asarray(a) for a in (x, wi[sel], wu[sel], wo[sel])]
    keep = np.ones((g, t), bool)
    if gr is not None:
        keep &= np.arange(t)[None, :] < np.asarray(gr)[:, None]
    if ge is not None:
        keep &= (np.asarray(ge) >= 0)[:, None]
    want = np.where(keep[..., None], np.asarray(j_grouped_ffn(
        *j, ffn_type=ffn_type, block_t=8, block_f=32, interpret=True)), 0.0)
    close(got, want)
    assert not np.asarray(got)[~keep].any()      # exact zeros there


def test_plain_versions_count_no_launches_and_reset_zeroes():
    reset_counters()
    assert sorted(COUNTERS) == sorted([
        "topk_gating_fused", "topk_positions", "dispatch_rows",
        "combine_rows", "weighted_route", "grouped_ffn", "grouped_matmul",
        "flash_attention", "rwkv6_wkv", "ssd_scan"])
    topk_positions(torch.zeros((4, 1), dtype=torch.int32), 2)
    assert all(c.count == 0 for c in COUNTERS.values())
    COUNTERS["grouped_ffn"].inc()
    reset_counters()
    assert COUNTERS["grouped_ffn"].count == 0


def test_ops_reject_tensors_off_cpu_and_cuda():
    meta = torch.zeros((4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.topk_positions_op(meta, 4)
    assert ops.resolve_backend("auto") == ops.resolve_backend("pallas") \
        == "pallas"
    assert ops.resolve_backend("xla") == "xla"
    with pytest.raises(ValueError):
        ops.resolve_backend("tpu")
