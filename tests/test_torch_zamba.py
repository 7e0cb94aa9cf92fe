"""``zamba2-1.2b`` in the port against the reference on the CPU: the config,
the SSD kernel's plain route against the reference's Pallas kernel in
interpret mode, its oracle ``ref_ssd`` and the model's ``ssd_chunked``
(with its initial and final state), the Mamba2 block (``mamba_block``,
``mamba_decode``) and the served hybrid model (``forward_prefill``,
``init_cache``, ``decode_step``: Mamba2 layers and the shared attention
block on its taps) at the ``-smoke`` config in float32; and, at depth
24, that the port's bf16 drifts from its float32 as far as the
reference's.

The same seeded numpy inputs go to both packages; weights through
``repro_torch.convert.from_reference``.  Kernel-level floats within
atol = rtol = 2e-5, as the reference's own SSD kernel test; model-level
within 1e-4.  The CUDA kernel is held against the plain version on the card
by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_scan as j_ssd
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import COUNTERS, ref, reset_counters, ssd_op
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import lm
from repro_torch.models import ssm
from repro_torch.tree import tree_items, tree_leaves, tree_map
from _torch_threads import share_cores

share_cores()

KTOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "zamba2-1.2b-smoke"


def ssd_inputs(rng, b, t, h, p, n):
    x = rng.randn(b, t, h, p).astype(np.float32) * 0.3
    dt = rng.randn(b, t, h).astype(np.float32) * 0.5
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bb, cc = (rng.randn(b, t, n).astype(np.float32) * 0.3 for _ in range(2))
    d = np.ones((h,), np.float32)
    return x, dt, a_log, bb, cc, d


def tt(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("name", ["zamba2-1.2b", ARCH])
def test_config_matches_reference(name):
    want, got = j_get_config(name), get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_pattern == want.layer_pattern


def test_full_config_has_six_taps_over_38_mamba2_layers():
    cfg = get_config("zamba2-1.2b")
    assert sum(ch in "A*" for ch in cfg.layer_pattern) == 6
    assert (cfg.n_layers, cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.chunk,
            ssm.dims(cfg)) == (38, 64, 64, 128, (4096, 64, 64, 64))


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(1, 32, 2, 16, 8, 8),
                                             (2, 64, 2, 32, 16, 16),
                                             (2, 48, 4, 16, 8, 16),
                                             (2, 45, 2, 16, 8, 16)])  # ragged
def test_ssd_matches_pallas_kernel_and_oracle(b, t, h, p, n, chunk):
    args = ssd_inputs(np.random.RandomState(t + h), b, t, h, p, n)
    reset_counters()
    got = ssd_scan(*tt(*args)).numpy()
    assert COUNTERS["ssd_scan"].count == 0           # plain version only
    ja = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(j_ssd(*ja, chunk=chunk)),
                               **KTOL)
    np.testing.assert_allclose(got, np.asarray(jref.ref_ssd(*ja)), **KTOL)


@pytest.mark.parametrize("t,chunk", [(40, 16), (45, 7)])
def test_ssd_chunked_and_state_match_reference(t, chunk):
    """The model's ssd_chunked (y and final state, with an initial state)
    against the reference's, and two strided calls carrying the state
    against one."""
    rng = np.random.RandomState(t)
    b, h, p, n = 2, 4, 16, 8
    x, dt, a_log, bb, cc, d = ssd_inputs(rng, b, t, h, p, n)
    h0 = rng.randn(b, h, p, n).astype(np.float32) * 0.3
    y, h_t = ssm.ssd_chunked(*tt(x, dt, a_log, bb, cc, d), chunk,
                             torch.tensor(h0))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bb,
                                                         cc, d)),
                              chunk, jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), **TOL)
    # x, B and C as slices of one projection, in two calls
    xbc = torch.tensor(np.concatenate([x.reshape(b, t, h * p), bb, cc], -1))
    xs = xbc[..., :h * p].reshape(b, t, h, p)
    bs, cs = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dtt, al, dd = tt(dt, a_log, d)
    cut = t // 3
    y1, h1 = ssd_op(xs[:, :cut], dtt[:, :cut], al, bs[:, :cut], cs[:, :cut],
                    dd, torch.tensor(h0), return_state=True)
    y2, h2 = ssd_op(xs[:, cut:], dtt[:, cut:], al, bs[:, cut:], cs[:, cut:],
                    dd, h1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **TOL)
    np.testing.assert_allclose(h2.numpy(), h_t.numpy(), **TOL)
    yp, hp = ref.ref_ssd(xs, dtt, al, bs, cs, dd, torch.tensor(h0),
                         return_state=True)
    np.testing.assert_allclose(yp.numpy(), y.numpy(), **KTOL)


def test_ssd_wrapper_refuses_bad_shapes():
    x, dt, a_log, bb, cc, d = tt(*ssd_inputs(np.random.RandomState(0), 1, 8,
                                             2, 16, 8))
    with pytest.raises(ValueError, match="dt "):
        ssd_scan(x, dt[:, :4], a_log, bb, cc, d)
    with pytest.raises(ValueError, match="b "):
        ssd_scan(x, dt, a_log, bb[..., :4], cc, d)
    with pytest.raises(ValueError, match="h0 "):
        ssd_scan(x, dt, a_log, bb, cc, d, h0=torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ssd_scan(x.to("meta"), dt, a_log, bb, cc, d)


# ---------------------------------------------------------------------------
# the model at the smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def layer(tree, i):
    return type(tree)(*(a[i] for a in tree))


def test_from_reference_round_trips_the_hybrid_stack(models):
    _, cfg, jp, params = models
    assert isinstance(params.stack, lm.HybridParams)
    assert params.stack.mamba.in_proj.shape[0] == cfg.n_layers
    np_p = jax.tree.map(np.asarray, jp)
    back = dict(tree_items(to_reference(params, np_p)))
    want = dict(tree_items(np_p))
    assert back.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)


def test_mamba_block_and_decode_match_reference(models):
    jcfg, cfg, jp, params = models
    rng = np.random.RandomState(7)
    x = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    jm, pm = layer(jp.stack.mamba, 2), layer(params.stack.mamba, 2)
    want = jssm.mamba_block(jm, jcfg, jnp.asarray(x))
    got = ssm.mamba_block(pm, cfg, torch.tensor(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # decode from the block's final state, one token
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    want = jssm.mamba_decode(jm, jcfg, jnp.asarray(x1), want[1])
    got = ssm.mamba_decode(pm, cfg, torch.tensor(x1), got[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prefill_and_decode_match_reference(models):
    """forward_prefill logits, then 8 decode steps (logits, the KV cache of
    the shared block's taps and the Mamba2 states), and the port's decode
    at the end against its own prefill."""
    jcfg, cfg, jp, params = models
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 8))
    reset_counters()
    with torch.inference_mode():
        pre = lm.forward_prefill(cfg, params, {"tokens": torch.tensor(toks)})
    jpre = jlm.forward_prefill(None, jcfg, jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(pre.logits.numpy(), np.asarray(jpre.logits),
                               **TOL)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.float32)
    cache = lm.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert cache.rwkv is None and cache.kv.k.shape[0] == 1   # one tap
    for (k, w), (_, g) in zip(tree_items(jax.tree.map(np.asarray, jc)),
                              tree_items(to_reference(cache, jc))):
        assert g.shape == w.shape and g.dtype == w.dtype, k
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(None, jcfg, p, c, t))
    for i in range(8):
        jl, jc, _ = jstep(jp, jc, jnp.asarray(toks[:, i]))
        with torch.inference_mode():
            logits, cache, experts = lm.decode_step(
                cfg, params, cache, torch.tensor(toks[:, i]))
        assert experts is None
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for (k, w), (_, g) in zip(tree_items(jax.tree.map(np.asarray, jc)),
                                  tree_items(to_reference(cache, jc))):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert int(cache.pos[0]) == 8
    np.testing.assert_allclose(logits.numpy(), pre.logits.numpy(), **TOL)
    assert all(c.count == 0 for c in COUNTERS.values())


def test_plain_route_matches_kernel_route(models):
    _, cfg, _, params = models
    plain = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, compute_backend="xla"))
    toks = torch.tensor(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (2, 20)))
    with torch.inference_mode():
        a = lm.forward_prefill(cfg, params, {"tokens": toks}).logits
        b = lm.forward_prefill(plain, params, {"tokens": toks}).logits
    np.testing.assert_allclose(a.numpy(), b.numpy(), **KTOL)


def test_training_refuses_and_the_card_is_the_default(models):
    """Training, which this family refused before the SSD backward kernel,
    now runs (its loss and gradients against the reference's are
    ``test_torch_train_recurrent.py``'s): a finite loss, a zero aux loss,
    no expert choices and a finite gradient for every leaf.  Without a
    card the entry points' default device raises."""
    _, cfg, _, params = models
    toks = torch.zeros((2, 8), dtype=torch.long)
    ps = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = lm.forward_train(cfg, ps, {"tokens": toks, "labels": toks})
    assert out.expert_choices is None and float(out.aux_loss) == 0.0
    grads = torch.autograd.grad(out.loss, tree_leaves(ps))
    assert np.isfinite(float(out.loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_cache(cfg, 2, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_params(cfg, torch.Generator())


def _bf16_drift(jcfg, cfg, toks):
    """Norm-wise drift of each row's last-position logits in bf16 from the
    same model in float32, for the reference and the port on the same
    weights; and the float32 gap between the two packages."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    out = {}
    for dt in ("float32", "bfloat16"):
        jc, c = (dataclasses.replace(x, dtype=dt) for x in (jcfg, cfg))
        out["ref", dt] = np.asarray(jlm.forward_prefill(
            None, jc, jp, {"tokens": jnp.asarray(toks)}).logits, np.float64)
        with torch.inference_mode():
            out["port", dt] = lm.forward_prefill(
                c, params, {"tokens": torch.tensor(toks)}).logits.double() \
                .numpy()

    def rel(a, b):
        return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    return (rel(out["ref", "bfloat16"], out["ref", "float32"]),
            rel(out["port", "bfloat16"], out["port", "float32"]),
            rel(out["port", "float32"], out["ref", "float32"]))


def test_bf16_drift_is_the_references():
    """At depth 24 the random-weight hybrid stack in bf16 drifts from itself
    in float32 (norm-wise ~0.05 of the logits here, and on the card at full
    width), in the reference as in the port: the port's drift is the
    reference's to within 1.5x either way, and the two packages agree in
    float32.  This is why chip_smoke.py holds the kernel route's bf16
    logits against the bf16 plain route's drift, not a fixed limit."""
    full = j_get_config("zamba2-1.2b")
    shape = dict(d_model=256, d_ff=1024, n_layers=24, n_heads=4,
                 n_kv_heads=4, vocab_size=4096, dtype="float32",
                 layer_pattern=full.layer_pattern[:24])
    jcfg = dataclasses.replace(full, **shape)
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), **shape)
    toks = np.random.RandomState(0).randint(0, 4096, (2, 64))
    ref_drift, port_drift, f32_gap = _bf16_drift(jcfg, cfg, toks)
    assert f32_gap.max() < 1e-4
    assert ref_drift.min() > 0.01
    ratio = port_drift / ref_drift
    assert ratio.max() < 1.5 and ratio.min() > 1 / 1.5, (port_drift,
                                                          ref_drift)
