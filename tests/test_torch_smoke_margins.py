"""``chip_smoke.py``'s router margins (``ulp_margins``), the bound its MoE
replay holds the kernel route's router probabilities and gate flips to: it
must cover every pattern of one-ulp shifts of the bf16 logits, grant an
expert no more than 2 p (1 - p) u of the token's largest logit, and let an
error beyond what one ulp explains fail.  On the CPU: the function is
plain torch.

Tolerances: the margins are first-order in the shifts; PROB_MARGIN (1e-3)
absorbs the second-order terms (u**2, at most ~2.4e-4 at u = 2**-6).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ulps(z):
    return torch.exp2(torch.floor(torch.log2(z.abs().clamp_min(2.0 ** -126)))
                      - 7)


def bf16_logits(t, e, scale, seed):
    z = np.random.RandomState(seed).randn(t, e).astype(np.float32) * scale
    return torch.from_numpy(z).bfloat16().float()


# (experts, k, logit scale): gpt2-moe, mixtral-8x22b, a wide router
CASES = [(16, 2, 1.0), (8, 2, 2.0), (64, 4, 1.5)]


@pytest.mark.parametrize("e,k,scale", CASES)
def test_margins_cover_every_one_ulp_shift(e, k, scale):
    cs = smoke()
    z = bf16_logits(500, e, scale, seed=e)
    p = torch.softmax(z, -1)
    ptol, gtol, gap = cs.ulp_margins(z, p, k)
    u = ulps(z)
    rows = torch.arange(z.shape[0])
    order = torch.sort(p, -1, descending=True).indices
    a, b = order[:, k - 1], order[:, k]
    assert torch.equal(gap, p[rows, a] - p[rows, b])
    # each expert's worst case (it up one ulp, every other down) and random
    # patterns of -1, 0, +1 ulp
    shifts = []
    for i in range(e):
        for sgn in (1.0, -1.0):
            d = -sgn * u.clone()
            d[:, i] = sgn * u[:, i]
            shifts.append(d)
    gen = torch.Generator().manual_seed(k)
    shifts += [u * torch.randint(-1, 2, z.shape, generator=gen).float()
               for _ in range(50)]
    for d in shifts:
        q = torch.softmax(z + d, -1)
        assert ((q - p).abs() <= ptol).all()
        moved = ((q[rows, a] - q[rows, b]) - gap).abs()
        assert (moved <= gtol).all()


@pytest.mark.parametrize("e,k,scale", CASES)
def test_margins_are_no_looser_than_half_an_ulp_of_the_top_logit(e, k, scale):
    cs = smoke()
    z = bf16_logits(500, e, scale, seed=e + 1)
    p = torch.softmax(z, -1)
    ptol, gtol, _ = cs.ulp_margins(z, p, k)
    top = ulps(z.abs().amax(-1, keepdim=True))
    rule = cs.PROB_MARGIN + 2 * p * (1 - p) * top
    assert (ptol <= rule * (1 + 1e-6)).all()
    assert (ptol <= cs.PROB_MARGIN + top / 2).all()
    assert (gtol <= cs.PROB_MARGIN + 2 * top[:, 0]).all()


# gpt2-moe's router logits at one token of a served prefill, where the two
# routes' bf16 logits of expert 0 (1.92) landed one ulp (2**-7) apart
TOKEN = [1.9219, -0.3555, -1.1875, -0.1436, 1.1641, 0.6289, -1.2969,
         -0.5938, 0.1592, -0.625, -0.7188, 0.8281, 2.0469, 0.9141, -0.4785,
         -0.1367]


@pytest.mark.parametrize("err,held", [(1.351e-3, True), (3e-3, True),
                                      (4e-3, False), (1.2e-2, False)])
def test_one_ulp_token_holds_and_larger_errors_fail(err, held):
    cs = smoke()
    z = torch.tensor([TOKEN]).bfloat16().float()
    p = torch.softmax(z, -1)
    ptol, _, _ = cs.ulp_margins(z, p, 2)
    shifted = z.clone()
    shifted[0, 0] += 2.0 ** -7
    assert (torch.softmax(shifted, -1) - p).abs().max() <= ptol[0, 0]
    assert bool(err <= ptol[0, 0]) == held


# ---------------------------------------------------------------------------
# phase 1's gating check: the exactly rounded logits and their flips
# ---------------------------------------------------------------------------

def router_case(t, d, e, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(t, d).astype(np.float32)).bfloat16()
    r = torch.from_numpy((rng.randn(d, e) / np.sqrt(d)).astype(
        np.float32)).bfloat16()
    return x, r


def k16_sum(x, r, order=None, splits=1):
    """The fp32 sum of the bf16 products in k16 steps (wgmma's ascending
    order) in ``splits`` contiguous ranges of 64-deep stages added in
    order; or one product at a time in ``order``."""
    prods = x.float()[:, :, None] * r.float()[None]       # exact in fp32
    acc = torch.zeros(x.shape[0], r.shape[1])
    if order is None:
        steps = -(-x.shape[1] // 64)
        for s in range(splits):
            lo, hi = s * steps // splits * 64, (s + 1) * steps // splits * 64
            part = torch.zeros_like(acc)
            for k0 in range(lo, min(hi, x.shape[1]), 16):
                part = part + prods[:, k0:k0 + 16].sum(1)
            acc = part if s == 0 else acc + part
    else:
        for i in order:
            acc = acc + prods[:, i]
    return acc


@pytest.mark.parametrize("t,d,e", [(2000, 768, 16), (4000, 1024, 8),
                                   (300, 512, 128)])
def test_flips_cover_every_fp32_order_that_rounds_otherwise(t, d, e):
    """Each logit that an fp32 sum of the same products, in k16 steps or
    one by one in a random order, rounds to another bf16 than the exact
    sum does carries a flip; and most logits carry none."""
    cs = smoke()
    x, r = router_case(t, d, e, seed=d + e)
    zb, flip = cs.rounded_logits(x, r)
    assert torch.equal(zb, (x.double() @ r.double()).to(torch.bfloat16))
    rng = np.random.RandomState(e)
    moved = 0
    for order, splits in [(None, 1), (None, 4), (None, 8)] + [
            (rng.permutation(d), 1) for _ in range(3)]:
        other = k16_sum(x, r, order, splits).bfloat16()
        differ = other != zb
        moved += int(differ.sum())
        assert bool((flip[differ] > 0).all())
        step = (other.double() - zb.double()).abs()
        assert bool((step[differ] <= flip[differ].double()).all())
    assert moved > 0
    assert float((flip > 0).float().mean()) < 0.15


def test_gating_check_holds_the_plain_route_and_fails_a_wrong_one():
    """check_gating passes the plain version on these inputs, and fails
    probabilities moved past their bound, a swapped id on a clear row, and
    a weight moved past its bound."""
    cs = smoke()
    from repro_torch.kernels import ref
    x, r = router_case(256, 768, 16, seed=1)
    k = 2
    got = ref.ref_topk_gating(x @ r, k)
    assert cs.check_gating("plain", x, r, k, got) < cs.PROB_MARGIN + 1e-2
    zb, flip = cs.rounded_logits(x, r)
    idx, w, probs = ref.ref_topk_gating(zb, k)
    dp, pair, gap = cs.shift_bounds(probs, flip, k)
    row = int(torch.argmax(gap))                 # the clearest row
    bad = probs.clone()
    bad[row, 0] += cs.PROB_MARGIN + float(dp[row, 0]) + 1e-4
    with pytest.raises(AssertionError, match="probs err"):
        cs.check_gating("bad probs", x, r, k, (idx, w, bad))
    swapped = idx.clone()
    swapped[row] = swapped[row].flip(0)
    with pytest.raises(AssertionError, match="ids differ"):
        cs.check_gating("bad ids", x, r, k, (swapped, w, probs))
    worse = w.clone()
    worse[row, 0] += 2e-2
    with pytest.raises(AssertionError, match="weights err"):
        cs.check_gating("bad weights", x, r, k, (idx, worse, probs))


def test_shift_bounds_is_ulp_margins_with_every_ulp():
    cs = smoke()
    z = bf16_logits(200, 16, 1.0, seed=3)
    p = torch.softmax(z, -1)
    ptol, gtol, gap = cs.ulp_margins(z, p, 2)
    dp, pair, gap2 = cs.shift_bounds(p, ulps(z), 2)
    assert torch.equal(ptol, cs.PROB_MARGIN + dp)
    assert torch.equal(gtol, cs.PROB_MARGIN + pair)
    assert torch.equal(gap, gap2)
