"""The dense configs (``moe.enabled`` False: a dense FFN in every block, no
expert choices) in the port against the reference on the CPU, through the
transformer family's model entry points: ``forward_prefill`` logits,
``init_cache`` (float32, as the reference's bf16 default cannot take the
float32 smoke model's scatter) and four ``decode_step``s (logits and the
KV cache), decode matching prefill at the prompt's end, and
``forward_train``'s loss (the reference's compared forward only).

The ``-smoke`` configs keep what sets each family apart: granite's MQA
(kv = 1) and its gelu FFN, qwen1.5's MHA and tied embeddings (no
``lm_head``: the unembedding is ``embed``), qwen3's ``qk_norm``, and
qwen1.5 / qwen2 / granite's QKV bias.  The reference initialises biases
to zero and norm scales to one; the tests draw them at random so that
both paths compute with them.  Integer outputs exact; floats within
atol = rtol = 1e-4 (float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import lm
from repro_torch.tree import tree_items, tree_map

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["granite-34b-smoke", "qwen3-8b-smoke", "qwen1.5-0.5b-smoke",
         "qwen2-72b-smoke"]
# (kv heads, ffn, tied, qk_norm, qkv_bias) the smoke config must keep
TRAITS = {"granite-34b-smoke": (1, "gelu", False, False, True),
          "qwen3-8b-smoke": (4, "swiglu", False, True, False),
          "qwen1.5-0.5b-smoke": (4, "swiglu", True, False, True),
          "qwen2-72b-smoke": (4, "swiglu", False, False, True)}
PROMPT = 4


def perturb(jp, rng):
    """The reference's params with the attention biases, qk-norm scales and
    every norm scale drawn at random (numpy leaves)."""
    def noise(a, base):
        return None if a is None else \
            (base + 0.3 * rng.randn(*a.shape)).astype(a.dtype)
    st = jp.stack
    attn = st.attn._replace(
        bq=noise(st.attn.bq, 0.0), bk=noise(st.attn.bk, 0.0),
        bv=noise(st.attn.bv, 0.0), q_norm=noise(st.attn.q_norm, 1.0),
        k_norm=noise(st.attn.k_norm, 1.0))
    st = st._replace(attn=attn, ln1=noise(st.ln1, 1.0),
                     ln2=noise(st.ln2, 1.0))
    return jp._replace(stack=st, final_norm=noise(jp.final_norm, 1.0))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    name = request.param
    jcfg, cfg = j_get_config(name), get_config(name)
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(
        ARCHS.index(name))))
    jp = perturb(jp, np.random.RandomState(ARCHS.index(name)))
    params = from_reference(jp, device="cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), params


def test_smoke_keeps_the_family_and_round_trips(models):
    jcfg, cfg, jp, params = models
    kv, ffn, tied, qk_norm, bias = TRAITS[cfg.name]
    assert not cfg.moe.enabled
    assert (cfg.n_kv_heads, cfg.ffn_type, cfg.tie_embeddings, cfg.qk_norm,
            cfg.qkv_bias) == (kv, ffn, tied, qk_norm, bias)
    st = params.stack
    assert st.moe is None and st.shared is None
    # one block a group, its dense FFN
    assert tuple(st.ffn.w_in.shape) == (cfg.n_layers, 1, cfg.d_model,
                                        cfg.d_ff)
    assert (st.ffn.w_up is None) == (ffn == "gelu")
    assert (params.lm_head is None) == tied
    assert (st.attn.bq is None) != bias
    assert (st.attn.q_norm is None) != qk_norm
    np_p = jax.tree.map(np.asarray, jp)
    back = dict(tree_items(to_reference(params, np_p)))
    want = dict(tree_items(np_p))
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_prefill_matches_reference(models):
    jcfg, cfg, jp, params = models
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (3, 16))
    reset_counters()
    with torch.inference_mode():
        got = lm.forward_prefill(cfg, params, {"tokens": torch.tensor(toks)})
    want = jlm.forward_prefill(None, jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.expert_choices is None and want.expert_choices is None
    assert got.aux_loss.item() == 0.0
    assert got.logits.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               **TOL)
    assert all(c.count == 0 for c in COUNTERS.values())


def test_decode_matches_reference_and_its_own_prefill(models):
    """init_cache (float32) and PROMPT decode steps against the reference
    (logits and the whole KV cache each step), then the last step's logits
    against the port's forward_prefill of the same PROMPT tokens."""
    jcfg, cfg, jp, params = models
    b = 2
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (b, PROMPT))
    jc = jlm.init_cache(jcfg, b, PROMPT + 2, jnp.float32)
    cache = lm.init_cache(cfg, b, PROMPT + 2, torch.float32, device="cpu")
    assert cache.mamba is None and cache.rwkv is None
    for (k, w), (_, g) in zip(tree_items(jax.tree.map(np.asarray, jc)),
                              tree_items(to_reference(cache, jc))):
        assert g.shape == w.shape and g.dtype == w.dtype, k
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(None, jcfg, p, c, t))
    for i in range(PROMPT):
        jl, jc, jexp = jstep(jp, jc, jnp.asarray(toks[:, i]))
        with torch.inference_mode():
            logits, cache, experts = lm.decode_step(
                cfg, params, cache, torch.tensor(toks[:, i]))
        assert experts is None and jexp is None
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for (k, w), (_, g) in zip(tree_items(jax.tree.map(np.asarray, jc)),
                                  tree_items(to_reference(cache, jc))):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert cache.pos.tolist() == [PROMPT] * b
    with torch.inference_mode():
        pre = lm.forward_prefill(cfg, params, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(logits.numpy(), pre.logits.numpy(), **TOL)


def test_forward_train_matches_reference(models):
    jcfg, cfg, jp, params = models
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=2)).batch(0)
    want = jlm.forward_train(None, jcfg, jp,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             lina=False)
    got = lm.forward_train(cfg, params,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.expert_choices is None and want.expert_choices is None
    assert got.aux_loss.item() == 0.0
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **TOL)


def test_forward_train_is_differentiable(models):
    """Every leaf of the dense model gets a finite, non-zero gradient (the
    reference's gradient through the stack does not run here, so there is
    nothing to compare it with)."""
    _, cfg, _, params = models
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=2, seed=3)).batch(0)
    lm.forward_train(cfg, p, {k: torch.from_numpy(v)
                              for k, v in batch.items()}).loss.backward()
    for k, a in tree_items(p):
        assert a.grad is not None and torch.isfinite(a.grad).all(), k
        assert a.grad.abs().max() > 0, k
