"""The port's serving engine against the reference's on the CPU: the same
Poisson trace replayed through ``simulate`` on ``gpt2-moe-smoke`` (float32,
same converted weights and path profile) generates the same tokens per
request, with the same plan-reuse, fine-tune and plan-cache counts.

``time_scale=0`` takes the measured wall time out of the virtual clock, so
both engines form the same micro-batches from the arrival times alone.
"""
import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.runtime.engine import EngineConfig as JEngineConfig
from repro.runtime.engine import ServingEngine as JServingEngine
from repro.runtime.engine import simulate as j_simulate
from repro.runtime.server import MoEServer as JMoEServer
from repro.runtime.server import profile_from_training as j_profile
from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                        simulate, summarize_results)
from repro_torch.runtime.server import MoEServer, profile_from_training


def _trace(vocab, n=6, seq=12, rate=40.0, seed=1000):
    rng = np.random.RandomState(seed)
    t, trace = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        trace.append((rng.randint(0, vocab, (seq,)), t))
    return trace


def test_simulate_generates_the_reference_tokens():
    jcfg = j_get_config("gpt2-moe-smoke")
    cfg = get_config("gpt2-moe-smoke")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    jprof = j_profile(jcfg, jparams, (ds.batch(i) for i in range(3)))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(3)),
                                 device="cpu")
    ecfg = dict(max_batch_tokens=48, max_batch_requests=4)
    jeng = JServingEngine(JMoEServer(jcfg, jparams, jprof),
                          JEngineConfig(**ecfg))
    eng = ServingEngine(MoEServer(cfg, params, prof, device="cpu"),
                        EngineConfig(**ecfg))
    trace = _trace(cfg.vocab_size)
    want = sorted(j_simulate(jeng, trace, time_scale=0.0, max_new_tokens=4),
                  key=lambda r: r.rid)
    got = sorted(simulate(eng, trace, time_scale=0.0, max_new_tokens=4),
                 key=lambda r: r.rid)
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.arrival, g.completion, g.ttft) == \
            (w.arrival, w.completion, w.ttft)
        np.testing.assert_allclose(g.logits, np.asarray(w.logits),
                                   atol=1e-4, rtol=1e-4)
    assert eng.step_idx == jeng.step_idx
    assert (eng._finetunes, eng._layers_served) == \
        (jeng._finetunes, jeng._layers_served)
    assert eng.plan_reuse_rate == jeng.plan_reuse_rate
    assert vars(eng.server.plan_cache.stats) == \
        vars(jeng.server.plan_cache.stats)
    m = summarize_results(got, eng)
    assert m["n"] == 6 and m["gen_tokens"] == 24 and m["submitted"] == 6
