"""``rwkv6-1.6b`` in the port against the reference on the CPU: the config,
the WKV kernel's plain route against the reference's Pallas kernel in
interpret mode and its oracle ``ref_rwkv6``, the initial / final state that
the decode step carries, ``wkv_chunked``, the RWKV6 block (``time_mix``,
``channel_mix``) and the served model (``forward_prefill``, ``init_cache``,
``decode_step``) at the ``-smoke`` config in float32; and, at depth 24,
that the port's bf16 drifts from its float32 as far as the reference's.

The same seeded numpy inputs go to both packages; weights through
``repro_torch.convert.from_reference``, with the bonus ``u`` set to random
values first (the models start it at zero, which would leave its term
untested).  Kernel-level floats within atol = rtol = 1e-5, as the
reference's own kernel tests; model-level within 1e-4.  The CUDA kernel is
held against the plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.rwkv6 import rwkv6_wkv as j_wkv
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import COUNTERS, ref, reset_counters, rwkv6_op
from repro_torch.kernels.rwkv6 import rwkv6_wkv
from repro_torch.models import lm
from repro_torch.models import rwkv
from repro_torch.tree import tree_items, tree_leaves, tree_map

KTOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-1.6b-smoke"


def wkv_inputs(rng, b, t, h, hd):
    r, k, v = (rng.randn(b, t, h, hd).astype(np.float32) * 0.3
               for _ in range(3))
    w = -np.exp(rng.randn(b, t, h, hd).astype(np.float32) * 0.5)
    u = rng.randn(h, hd).astype(np.float32) * 0.3
    return r, k, v, w, u


def tt(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("name", ["rwkv6-1.6b", ARCH])
def test_config_matches_reference(name):
    want, got = j_get_config(name), get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attention_free and got.ssm.head_dim == want.ssm.head_dim


@pytest.mark.parametrize("b,t,h,hd,chunk", [(1, 32, 2, 16, 8),
                                            (2, 64, 2, 32, 16),
                                            (2, 48, 4, 16, 16),
                                            (2, 45, 2, 16, 16)])   # ragged
def test_wkv_matches_pallas_kernel_and_oracle(b, t, h, hd, chunk):
    r, k, v, w, u = wkv_inputs(np.random.RandomState(t + h), b, t, h, hd)
    reset_counters()
    got = rwkv6_wkv(*tt(r, k, v, w, u)).numpy()
    assert COUNTERS["rwkv6_wkv"].count == 0          # plain version only
    jr = [jnp.asarray(a) for a in (r, k, v, w, u)]
    np.testing.assert_allclose(got, np.asarray(j_wkv(*jr, chunk=chunk)),
                               **KTOL)
    np.testing.assert_allclose(got, np.asarray(jref.ref_rwkv6(*jr)), **KTOL)


@pytest.mark.parametrize("cut", [1, 17, 32])
def test_wkv_state_carries_across_calls(cut):
    """Two calls, the second from the first's final state, equal one call
    (the decode step's use) and the reference's oracle."""
    r, k, v, w, u = wkv_inputs(np.random.RandomState(cut), 2, 40, 2, 16)
    r, k, v, w, u = tt(r, k, v, w, u)
    y_all, s_all = rwkv6_wkv(r, k, v, w, u, return_state=True)
    y1, s1 = rwkv6_wkv(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut], u,
                       return_state=True)
    y2, s2 = rwkv6_wkv(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:], u,
                       s0=s1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), **KTOL)
    np.testing.assert_allclose(s2.numpy(), s_all.numpy(), **KTOL)
    want = jref.ref_rwkv6(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(y_all.numpy(), np.asarray(want), **KTOL)


@pytest.mark.parametrize("t,chunk", [(1, 1), (24, 16), (40, 64)])
def test_wkv_chunked_with_state_matches_reference(t, chunk):
    rng = np.random.RandomState(t)
    b, h, hd = 2, 4, 16
    r, k, v, w, _ = wkv_inputs(rng, b, t, h, hd)
    u = rng.randn(h * hd).astype(np.float32) * 0.3
    s0 = rng.randn(b, h, hd, hd).astype(np.float32) * 0.5
    flat = [a.reshape(b, t, h * hd) for a in (r, k, v, w)]
    y, s_t = rwkv.wkv_chunked(*tt(*flat, u), h, hd, chunk,
                              torch.tensor(s0))
    jy, js = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in (*flat, u)), h, hd,
                               chunk, jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(js), **TOL)
    yp, sp = rwkv.wkv_chunked(*tt(*flat, u), h, hd, chunk, torch.tensor(s0),
                              use_kernel=False)
    np.testing.assert_allclose(yp.numpy(), y.numpy(), **KTOL)


def test_wkv_wrapper_refuses_bad_shapes():
    r, k, v, w, u = tt(*wkv_inputs(np.random.RandomState(0), 1, 8, 2, 16))
    with pytest.raises(ValueError, match="does not match"):
        rwkv6_wkv(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="u "):
        rwkv6_wkv(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0 "):
        rwkv6_wkv(r, k, v, w, u, s0=torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rwkv6_op(r.to("meta"), k, v, w, u)


# ---------------------------------------------------------------------------
# the model at the smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    u = np.random.RandomState(9).randn(*jp.stack.blocks.u.shape) * 0.5
    jp = jp._replace(stack=jp.stack._replace(
        blocks=jp.stack.blocks._replace(u=u.astype(np.float32))))
    jp = jax.tree.map(jnp.asarray, jp)
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def layer(tree, i):
    return type(tree)(*(a[i] for a in tree))


def test_from_reference_round_trips_the_rwkv_stack(models):
    _, _, jp, params = models
    assert isinstance(params.stack, lm.RWKVStack)
    assert float(params.stack.blocks.u.abs().max()) > 0
    np_p = jax.tree.map(np.asarray, jp)
    back = dict(tree_items(to_reference(params, np_p)))
    want = dict(tree_items(np_p))
    assert back.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)


def test_time_mix_and_channel_mix_match_reference(models):
    jcfg, cfg, jp, params = models
    rng = np.random.RandomState(4)
    x = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    jb, pb = layer(jp.stack.blocks, 1), layer(params.stack.blocks, 1)
    h, hd = rwkv._heads(cfg)
    state = (rng.randn(2, h, hd, hd).astype(np.float32) * 0.3,
             rng.randn(2, cfg.d_model).astype(np.float32),
             rng.randn(2, cfg.d_model).astype(np.float32))
    for st in (None, state):
        jst = None if st is None else jrwkv.RWKVState(*map(jnp.asarray, st))
        pst = None if st is None else rwkv.RWKVState(*tt(*st))
        want = jrwkv.time_mix(jb, jcfg, jnp.asarray(x), jst)
        got = rwkv.time_mix(pb, cfg, torch.tensor(x), pst)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for last in (None, state[2]):
        want = jrwkv.channel_mix(
            jb, jnp.asarray(x), None if last is None else jnp.asarray(last))
        got = rwkv.channel_mix(
            pb, torch.tensor(x), None if last is None else torch.tensor(last))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prefill_and_decode_match_reference(models):
    """forward_prefill logits, then 8 decode steps (logits and every
    state), and the port's decode at the end against its own prefill."""
    jcfg, cfg, jp, params = models
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 8))
    reset_counters()
    with torch.inference_mode():
        pre = lm.forward_prefill(cfg, params, {"tokens": torch.tensor(toks)})
    jpre = jlm.forward_prefill(None, jcfg, jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(pre.logits.numpy(), np.asarray(jpre.logits),
                               **TOL)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.float32)
    cache = lm.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert cache.kv is None and cache.mamba is None
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
    toks = torch.tensor(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 12)))
    with torch.inference_mode():
        a = lm.forward_prefill(cfg, params, {"tokens": toks}).logits
        b = lm.forward_prefill(plain, params, {"tokens": toks}).logits
    np.testing.assert_allclose(a.numpy(), b.numpy(), **KTOL)


def test_training_and_the_transformer_entry_points_refuse(models):
    """Training, which this family refused before the WKV backward kernel,
    now runs (its loss and gradients against the reference's are
    ``test_torch_train_recurrent.py``'s): a finite loss, a zero aux loss,
    no expert choices and a finite gradient for every leaf.  The
    transformer family's serve entry points, which refused before, take it
    too (its cache below)."""
    _, cfg, _, params = models
    toks = torch.zeros((2, 8), dtype=torch.long)
    ps = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = lm.forward_train(cfg, ps, {"tokens": toks, "labels": toks})
    assert out.expert_choices is None and float(out.aux_loss) == 0.0
    grads = torch.autograd.grad(out.loss, tree_leaves(ps))
    assert np.isfinite(float(out.loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_transformer_init_cache_has_the_reference_shape():
    moe = get_config("gpt2-moe-smoke")
    got = lm.init_cache(moe, 2, 8, device="cpu")
    want = jlm.init_cache(j_get_config("gpt2-moe-smoke"), 2, 8)
    assert got.kv.k.shape == got.kv.v.shape == want.kv.k.shape
    assert got.kv.k.dtype == torch.bfloat16 and not got.kv.k.any()


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
    """At depth 24 the random-weight RWKV6 stack in bf16 drifts far from
    itself in float32 (norm-wise ~0.2 of the logits here, and on the card at
    full width), in the reference as in the port: the port's drift is the
    reference's to within 1.5x either way, and the two packages agree in
    float32.  This is why chip_smoke.py holds the kernel route's bf16
    logits against the bf16 plain route's drift, not a fixed limit."""
    shape = dict(d_model=128, d_ff=448, n_layers=24, vocab_size=4096,
                 dtype="float32")
    jcfg = dataclasses.replace(j_get_config("rwkv6-1.6b"), **shape)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), **shape)
    toks = np.random.RandomState(0).randint(0, 4096, (2, 64))
    ref_drift, port_drift, f32_gap = _bf16_drift(jcfg, cfg, toks)
    assert f32_gap.max() < 1e-4
    assert ref_drift.min() > 0.05
    ratio = port_drift / ref_drift
    assert ratio.max() < 1.5 and ratio.min() > 1 / 1.5, (port_drift,
                                                          ref_drift)
