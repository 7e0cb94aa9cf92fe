"""``llama4-maverick-400b-a17b`` in the port against the reference on the
CPU: the parameter conversion of its interleaved stack (``every=2``: a
dense block and an MoE block a group, the shared expert beside top-1
routing), ``MoEServer`` on the same profile (``serve_batch``, prefill and
two decode steps, under both compute backends) and ``forward_train``'s
loss, aux loss and expert choices.

The stock ``llama4-maverick-400b-a17b-smoke`` has 4 query heads over
min(8, 4) = 4 KV heads, i.e. MHA; the tests also run a variant with
``n_heads=4, n_kv_heads=2`` so that the GQA index map runs, as the full
config's 40 / 8 heads do.  The reference's ``forward_train`` is compared
forward only (its gradient through the stack does not run on this CPU).
Integer outputs exact; floats within atol = rtol = 1e-4 (float32).  Also
``models.layers.dense_init``'s in-place scaling, which keeps llama4's
initialisation on the card to one fp32 transient a leaf, bitwise against
the out-of-place expression.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.runtime.server import MoEServer as JMoEServer
from repro.runtime.server import profile_from_training as j_profile
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import lm
from repro_torch.runtime.server import MoEServer, profile_from_training
from repro_torch.tree import tree_items

ARCH = "llama4-maverick-400b-a17b-smoke"
TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = {"mha": {}, "gqa": dict(n_heads=4, n_kv_heads=2)}


def cfgs(heads, backend="auto"):
    jcfg = dataclasses.replace(j_get_config(ARCH), **HEADS[heads])
    cfg = dataclasses.replace(get_config(ARCH), **HEADS[heads])
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, compute_backend=backend))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, compute_backend=backend))
    return jcfg, cfg


def test_full_config_is_the_served_width():
    cfg = get_config("llama4-maverick-400b-a17b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.ffn_type, cfg.param_dtype) == \
        (5120, 40, 8, 128, 16384, 202048, "swiglu", "bfloat16")
    assert (cfg.moe.n_experts, cfg.moe.d_ff, cfg.moe.top_k, cfg.moe.every,
            cfg.moe.shared_expert) == (128, 8192, 1, 2, True)
    smoke = get_config(ARCH)
    assert (smoke.moe.every, smoke.moe.top_k, smoke.moe.shared_expert) == \
        (2, 1, True)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_from_reference_round_trips_the_interleaved_stack(heads):
    jcfg, cfg = cfgs(heads)
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(2)))
    params = from_reference(jp, device="cpu")
    st, hd = params.stack, cfg.resolved_head_dim
    g = cfg.n_layers // 2
    # a group: two attention blocks, one dense FFN, the MoE and the shared
    # expert
    assert tuple(st.attn.wq.shape) == (g, 2, 64, cfg.n_heads * hd)
    assert tuple(st.attn.wk.shape) == (g, 2, 64, cfg.n_kv_heads * hd)
    assert tuple(st.ffn.w_in.shape) == (g, 1, 64, cfg.d_ff)
    assert tuple(st.moe.wi.shape) == (g, cfg.moe.n_experts, 64,
                                      cfg.moe.d_ff)
    assert tuple(st.shared.w_in.shape) == (g, 64, cfg.moe.d_ff)
    assert params.lm_head is not None
    back = dict(tree_items(to_reference(params, jp)))
    want = dict(tree_items(jp))
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_forward_train_matches_reference(heads):
    jcfg, cfg = cfgs(heads)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=1)).batch(0)
    want = jlm.forward_train(None, jcfg, jp,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             lina=False)
    got = lm.forward_train(cfg, params,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    # one row of top-1 choices per MoE layer (every second block)
    assert got.expert_choices.shape == (cfg.n_layers // 2, 4 * 32)
    np.testing.assert_array_equal(got.expert_choices.numpy(),
                                  np.asarray(want.expert_choices))
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **TOL)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss),
                               **TOL)
    assert got.aux_loss.item() > 0


@pytest.fixture(scope="module",
                params=[(h, b) for h in sorted(HEADS) for b in ("xla",
                                                                "auto")],
                ids=lambda p: "-".join(p))
def servers(request):
    jcfg, cfg = cfgs(*request.param)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    jprof = j_profile(jcfg, jparams, (ds.batch(i) for i in range(3)))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(3)),
                                 device="cpu")
    np.testing.assert_array_equal(prof.counts, jprof.counts)
    return JMoEServer(jcfg, jparams, jprof), MoEServer(cfg, params, prof,
                                                       device="cpu")


def assert_stats_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("layer", "finetuned", "est_accurate", "plan_reused",
                  "n_tokens"):
            assert getattr(g, f) == getattr(w, f), (f, g.layer)
        np.testing.assert_array_equal(g.replica_load, w.replica_load)
        for f in ("est_pop", "actual_pop", "device_load"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), **TOL)


def test_serve_batch_matches_reference(servers):
    jsrv, srv = servers
    tokens = np.random.RandomState(5).randint(0, srv.cfg.vocab_size, (3, 12))
    lengths = np.array([12, 7, 10])
    want = jsrv.serve_batch(tokens, lengths=lengths)
    got = srv.serve_batch(tokens, lengths=lengths)
    # one MoE layer a group of two blocks
    assert len(got.stats) == srv.cfg.n_layers // 2
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)


def test_prefill_and_decode_match_reference(servers):
    jsrv, srv = servers
    rng = np.random.RandomState(0)
    b, s, vocab = 3, 6, srv.cfg.vocab_size
    tokens = rng.randint(0, vocab, (b, s))
    lengths = np.array([6, 4, 5])
    reset_counters()
    want = jsrv.prefill_batch(tokens, lengths=lengths, cache_len=s + 2)
    got = srv.prefill_batch(tokens, lengths=lengths, cache_len=s + 2)
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)

    jc, c = want.cache, got.cache
    state = want.path_ids[np.arange(b), lengths - 1]
    jstate = state.copy()
    nxt = np.argmax(got.logits, axis=-1)
    for _ in range(2):
        jd = jsrv.decode_batch(nxt, jc, jstate)
        d = srv.decode_batch(nxt, c, state)
        np.testing.assert_allclose(d.logits, np.asarray(jd.logits), **TOL)
        np.testing.assert_array_equal(d.path_state, jd.path_state)
        assert_stats_equal(d.stats, jd.stats)
        np.testing.assert_allclose(d.cache.kv.k.numpy(),
                                   np.asarray(jd.cache.kv.k), **TOL)
        nxt = np.argmax(d.logits, axis=-1)
        jc, c, jstate, state = jd.cache, d.cache, jd.path_state, d.path_state
    assert vars(srv.plan_cache.stats) == vars(jsrv.plan_cache.stats)
    # CPU tensors take the plain versions: no kernel launches
    assert all(ctr.count == 0 for ctr in COUNTERS.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [((3, 64, 96), -2), ((512, 64), -1),
                                        ((2, 4, 64, 32), -2)])
def test_dense_init_scales_in_place_bitwise(shape, axis, dtype):
    """``dense_init`` scales its draws in place (one fp32 transient): the
    same draws times the same scale as the out-of-place expression."""
    from repro_torch.models.layers import dense_init
    got = dense_init(torch.Generator().manual_seed(7), shape, axis,
                     dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(7)
    want = (torch.randn(shape, generator=gen) * shape[axis] ** -0.5).to(dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
