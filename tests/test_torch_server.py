"""``MoEServer`` of the port against the reference's on the CPU, with the
same converted weights and the same path profile on ``gpt2-moe-smoke``
(float32): prefill (right-padded rows, carried path state) and two decode
steps — logits, rolling path ids and every ``LayerStats`` field.

Integer / boolean outputs exact; floats within atol = rtol = 1e-4.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.runtime.server import MoEServer as JMoEServer
from repro.runtime.server import profile_from_training as j_profile
from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.runtime.server import MoEServer, profile_from_training

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def servers():
    jcfg = j_get_config("gpt2-moe-smoke")
    cfg = get_config("gpt2-moe-smoke")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = from_reference(jax.tree.map(np.asarray, jparams))
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
    b, s, vocab = 4, 12, srv.cfg.vocab_size
    tokens = rng.randint(0, vocab, (b, s))
    lengths = np.array([12, 9, 5, 0])
    path_init = rng.randint(0, srv.profile.n_buckets, (b, s))
    want = jsrv.prefill_batch(tokens, lengths=lengths, path_init=path_init,
                              cache_len=s + 2)
    got = srv.prefill_batch(tokens, lengths=lengths, path_init=path_init,
                            cache_len=s + 2)
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)
    assert vars(srv.plan_cache.stats) == vars(jsrv.plan_cache.stats)

    jc, c = want.cache, got.cache
    jstate = want.path_ids[np.arange(b), np.maximum(lengths - 1, 0)]
    state = jstate.copy()
    nxt = np.argmax(got.logits, axis=-1)
    valid = lengths > 0
    for _ in range(2):
        jd = jsrv.decode_batch(nxt, jc, jstate, valid=valid)
        d = srv.decode_batch(nxt, c, state, valid=valid)
        np.testing.assert_allclose(d.logits, np.asarray(jd.logits), **TOL)
        np.testing.assert_array_equal(d.path_state, jd.path_state)
        assert_stats_equal(d.stats, jd.stats)
        np.testing.assert_array_equal(d.cache.pos.numpy(),
                                      np.asarray(jd.cache.pos))
        np.testing.assert_allclose(d.cache.kv.k.numpy(),
                                   np.asarray(jd.cache.kv.k), **TOL)
        nxt = np.argmax(d.logits, axis=-1)
        assert (nxt == np.argmax(np.asarray(jd.logits), -1)).all()
        jc, c, jstate, state = jd.cache, d.cache, jd.path_state, d.path_state
    assert vars(srv.plan_cache.stats) == vars(jsrv.plan_cache.stats)


def test_fail_devices_reroutes_like_the_reference(servers):
    jsrv, srv = servers
    tokens = np.random.RandomState(8).randint(0, srv.cfg.vocab_size, (3, 10))
    for s in (jsrv, srv):
        s.fail_devices([1, 2])
    try:
        assert srv.dead_devices == jsrv.dead_devices == {1, 2}
        want = jsrv.prefill_batch(tokens)
        got = srv.prefill_batch(tokens)
        np.testing.assert_allclose(got.logits, np.asarray(want.logits),
                                   **TOL)
        assert_stats_equal(got.stats, want.stats)
        for st in got.stats:
            assert st.replica_load.reshape(srv.n_dev, -1)[[1, 2]].sum() == 0
    finally:
        for s in (jsrv, srv):
            s.dead_devices.clear()
            s._plan_arrays.clear()


def test_warmup_runs_every_path_and_leaves_no_scheduling_trace(servers):
    _, srv = servers
    plans = dict(srv.plan_cache._plans)
    stats = vars(srv.plan_cache.stats).copy()
    n = srv.warmup(seqs=(6,), rows=(1, 2, 3), max_new_tokens=2)
    # prefill + decode + (buckets 1, 2, 4) x (min_replicas 1, 2); the two
    # replica-table widths (n_dev, max_pack) are both 4 at smoke size
    assert n == 2 + 3 * 2
    assert srv.plan_cache._plans == plans
    assert vars(srv.plan_cache.stats) == stats


def test_serve_batch_matches_reference(servers):
    jsrv, srv = servers
    tokens = np.random.RandomState(5).randint(0, srv.cfg.vocab_size, (2, 10))
    want = jsrv.serve_batch(tokens)
    got = srv.serve_batch(tokens)
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)
