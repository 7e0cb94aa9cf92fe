"""Three of the paper's §7.1 models in the port against the reference on the
CPU: ``transformer-xl-moe``, ``bert2gpt2-moe`` and ``bert-large-moe`` (the
fourth, ``gpt2-moe``, has files of its own), at their ``-smoke`` configs
in float32 on the same converted weights and seeded numpy inputs:
``forward_train``'s loss, aux loss and per-layer expert choices;
``MoEServer.serve_batch``'s logits, path ids and layer stats on the same
profile; and, for the two causal models, ``prefill_batch`` and two
``decode_batch`` steps.  bert-large-moe is a bidirectional encoder: it is
scored, not decoded.

The reference's ``forward_train`` is compared forward only.  Integer
outputs exact; floats within atol = rtol = 1e-4 (float32, other sum
orders).
"""
import functools

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
from repro_torch.convert import from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.runtime.server import MoEServer, profile_from_training

ARCHS = ("transformer-xl-moe", "bert2gpt2-moe", "bert-large-moe")
CAUSAL = ARCHS[:2]
TOL = dict(atol=1e-4, rtol=1e-4)


def models(arch, seed):
    jcfg, cfg = j_get_config(arch + "-smoke"), get_config(arch + "-smoke")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    jcfg, jp, cfg, params = models(arch, 4)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=1)).batch(0)
    want = jlm.forward_train(None, jcfg, jp,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             lina=False)
    got = lm.forward_train(cfg, params,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.expert_choices.shape == (cfg.n_moe_layers, 4 * 32)
    np.testing.assert_array_equal(got.expert_choices.numpy(),
                                  np.asarray(want.expert_choices))
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **TOL)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss),
                               **TOL)


@functools.lru_cache(maxsize=None)
def servers(arch):
    """(reference server, port server) on the same weights and profile,
    built once per arch."""
    jcfg, jparams, cfg, params = models(arch, 1)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_reference(arch):
    jsrv, srv = servers(arch)
    tokens = np.random.RandomState(5).randint(0, srv.cfg.vocab_size, (3, 12))
    lengths = np.array([12, 7, 10])
    want = jsrv.serve_batch(tokens, lengths=lengths)
    got = srv.serve_batch(tokens, lengths=lengths)
    assert len(got.stats) == srv.cfg.n_moe_layers
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    np.testing.assert_array_equal(got.path_ids, want.path_ids)
    assert_stats_equal(got.stats, want.stats)


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_and_decode_match_reference(arch):
    jsrv, srv = servers(arch)
    assert srv.cfg.causal
    rng = np.random.RandomState(0)
    b, s = 3, 6
    tokens = rng.randint(0, srv.cfg.vocab_size, (b, s))
    lengths = np.array([6, 4, 5])
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
        nxt = np.argmax(d.logits, axis=-1)
        jc, c, jstate, state = jd.cache, d.cache, jd.path_state, d.path_state
    assert vars(srv.plan_cache.stats) == vars(jsrv.plan_cache.stats)
