"""The port's MoE transformer LM against the JAX reference on the CPU:
``forward_train`` loss and per-layer top-1 expert choices on
``gpt2-moe-smoke`` (float32) with the reference's weights converted by
``repro_torch.convert.from_reference``, for both of the port's dispatch
routes; the profiling stage built on it; and the layer primitives.

Expert choices exact; floats within atol = rtol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.runtime.server import profile_from_training as j_profile
from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import layers, lm
from repro_torch.runtime.server import profile_from_training

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("gpt2-moe-smoke")
    cfg = get_config("gpt2-moe-smoke")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def test_data_pipeline_is_bitwise_the_reference():
    a = SyntheticLM(DataConfig(vocab_size=512, seq_len=16, global_batch=4,
                               seed=3))
    b = JSyntheticLM(JDataConfig(vocab_size=512, seq_len=16, global_batch=4,
                                 seed=3))
    for step in range(3):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch(step)[key],
                                          b.batch(step)[key])


@pytest.mark.parametrize("dispatch_backend", ["scatter", "pallas"])
def test_forward_train_matches_reference(setup, dispatch_backend):
    jcfg, cfg, jparams, params = setup
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=1)).batch(0)
    want = jlm.forward_train(None, jcfg, jparams,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             lina=False)
    got = lm.forward_train(cfg, params,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           dispatch_backend=dispatch_backend)
    np.testing.assert_array_equal(got.expert_choices.numpy(),
                                  np.asarray(want.expert_choices))
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **TOL)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss),
                               **TOL)


def test_profile_from_training_matches_reference(setup):
    jcfg, cfg, jparams, params = setup
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    got = profile_from_training(cfg, params, (ds.batch(i) for i in range(2)),
                                device="cpu")
    want = j_profile(jcfg, jparams, (ds.batch(i) for i in range(2)))
    np.testing.assert_array_equal(got.counts, want.counts)


def test_layer_primitives_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 5, 4, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1))
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(k),
                      torch.from_numpy(pos))
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(k), jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    h = rng.randn(6, 16).astype(np.float32)
    w_in = rng.randn(16, 32).astype(np.float32) / 4
    w_out = rng.randn(32, 16).astype(np.float32) / 6
    np.testing.assert_allclose(
        layers.ffn_branch(torch.from_numpy(h), torch.from_numpy(w_in), None,
                          torch.from_numpy(w_out), "gelu").numpy(),
        np.asarray(jlayers.ffn_branch(jnp.asarray(h), jnp.asarray(w_in),
                                      None, jnp.asarray(w_out), "gelu")),
        **TOL)
