"""``mixtral-8x22b`` in the port against the reference on the CPU: the
config field by field (full size and smoke), the parameter conversion, and
``MoEServer`` (GQA, sliding window, swiglu experts) in prefill + two decode
steps and in a score-only ``serve_batch`` past the window, under both
compute backends.

The stock ``mixtral-8x22b-smoke`` has 4 query heads over min(8, 4) = 4 KV
heads, i.e. MHA, and a window of 16; these tests set ``n_heads=4,
n_kv_heads=2, sliding_window=8`` themselves so that the GQA index map and
the window mask both run.  Integer / boolean outputs exact; floats within
atol = rtol = 1e-4 (float32), as in ``tests/test_torch_server.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.runtime.server import MoEServer as JMoEServer
from repro.runtime.server import profile_from_training as j_profile
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.runtime.server import MoEServer, profile_from_training
from repro_torch.tree import tree_items

TOL = dict(atol=1e-4, rtol=1e-4)
GQA = dict(n_heads=4, n_kv_heads=2, sliding_window=8)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "mixtral-8x22b-smoke"])
def test_config_matches_reference(name):
    want, got = j_get_config(name), get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_full_config_is_the_served_width():
    cfg = get_config("mixtral-8x22b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.sliding_window, cfg.vocab_size, cfg.ffn_type) == \
        (6144, 48, 8, 128, 4096, 32768, "swiglu")
    assert (cfg.moe.n_experts, cfg.moe.d_ff, cfg.moe.top_k) == (8, 16384, 2)


def cfgs(backend):
    jcfg = dataclasses.replace(j_get_config("mixtral-8x22b-smoke"), **GQA)
    cfg = dataclasses.replace(get_config("mixtral-8x22b-smoke"), **GQA)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, compute_backend=backend))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, compute_backend=backend))
    return jcfg, cfg


def test_from_reference_round_trips_gqa_swiglu_params():
    jcfg, _ = cfgs("auto")
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(2)))
    params = from_reference(jp, device="cpu")
    hd = jcfg.resolved_head_dim
    assert tuple(params.stack.attn.wk.shape[-2:]) == (64, 2 * hd)
    assert tuple(params.stack.attn.wq.shape[-2:]) == (64, 4 * hd)
    assert params.stack.moe.wu is not None          # swiglu experts
    back = to_reference(params, jp)
    want = dict(tree_items(jp))
    got = dict(tree_items(back))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module", params=["xla", "auto"])
def servers(request):
    jcfg, cfg = cfgs(request.param)
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
    for _ in range(2):                    # fills the cache_len = 8 ring
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


def test_score_only_past_the_window_matches_reference(servers):
    jsrv, srv = servers
    tokens = np.random.RandomState(5).randint(0, srv.cfg.vocab_size, (2, 24))
    want = jsrv.serve_batch(tokens, lengths=np.array([24, 19]))
    got = srv.serve_batch(tokens, lengths=np.array([24, 19]))
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)
    with pytest.raises(NotImplementedError, match="beyond the window"):
        srv.prefill_batch(tokens, cache_len=24)
