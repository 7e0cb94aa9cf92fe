"""The port's flash attention on the CPU: the wrapper's plain version against
the reference's Pallas kernel in interpret mode, its oracle
``ref.ref_attention`` and the model's ``_sdpa``, on the same seeded numpy
inputs in float32; the port's query-blocked ``_sdpa_blockwise`` and its
``attention`` switch against the reference's; the wrapper's refusals.

Floats within atol = rtol = 1e-5 (float32; XLA and PyTorch sum in
different orders).  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.configs import get_config
from repro_torch.kernels import COUNTERS, flash_attention_op, reset_counters
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import AttnParams

# the attention modules (the packages re-export a function of that name)
JA = importlib.import_module("repro.models.attention")
PA = importlib.import_module("repro_torch.models.attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def qkv(rng, b, s, h, kv, hd=16):
    return (rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32))


@pytest.mark.parametrize("s", [48, 40])          # 40: the kernel halves bq
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_oracle_and_sdpa(causal, window,
                                                        heads, s):
    h, kv = heads
    q, k, v = qkv(np.random.RandomState(s * 7 + h * kv), 2, s, h, kv)
    reset_counters()
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (j_flash(jq, jk, jv, causal=causal, window=window,
                         interpret=True),
                 jref.ref_attention(jq, jk, jv, causal=causal, window=window),
                 JA._sdpa(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert COUNTERS["flash_attention"].count == 0     # plain version only


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 8)])
def test_sdpa_blockwise_matches_reference(causal, window):
    q, k, v = qkv(np.random.RandomState(3), 2, 48, 4, 2)
    got = PA._sdpa_blockwise(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=causal, window=window,
                             block_q=16).numpy()
    want = JA._sdpa_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, block_q=16)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    full = JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(full), **TOL)


def gqa_cfgs():
    """``mixtral-8x22b-smoke`` with GQA 4/2 and window 8 (the stock smoke
    variant turns GQA into MHA), in both packages."""
    over = dict(n_heads=4, n_kv_heads=2, sliding_window=8)
    return (dataclasses.replace(j_get_config("mixtral-8x22b-smoke"), **over),
            dataclasses.replace(get_config("mixtral-8x22b-smoke"), **over))


def attn_params(cfg, rng):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return [rng.randn(*shape).astype(np.float32) * shape[0] ** -0.5
            for shape in ((d, hq), (d, hkv), (d, hkv), (hq, d))]


@pytest.mark.parametrize("s", [24, 2050])   # 2050: past BLOCKWISE_THRESHOLD
def test_attention_routes_match_reference(s):
    jcfg, cfg = gqa_cfgs()
    rng = np.random.RandomState(s)
    ws = attn_params(cfg, rng)
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    jp = JA.AttnParams(*(jnp.asarray(w) for w in ws), None, None, None,
                       None, None)
    p = AttnParams(*(torch.tensor(w) for w in ws), None, None, None, None,
                   None)
    want_y, want_kv = JA.attention(None, jp, jnp.asarray(x), jcfg)
    reset_counters()
    outs = [PA.attention(p, torch.tensor(x), cfg, use_kernel=u)
            for u in (False, True)]
    assert COUNTERS["flash_attention"].count == 0
    for y, kv in outs:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(want_kv.k),
                                   **TOL)
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), **TOL)


def test_plain_path_switches_to_blockwise_past_threshold(monkeypatch):
    """Past the threshold the plain path takes the query-blocked form."""
    _, cfg = gqa_cfgs()
    ws = attn_params(cfg, np.random.RandomState(5))
    p = AttnParams(*(torch.tensor(w) for w in ws), None, None, None, None,
                   None)
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    calls = []
    real = PA._sdpa_blockwise
    monkeypatch.setattr(PA, "_sdpa_blockwise",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(PA, "BLOCKWISE_THRESHOLD", 32)
    y_block, _ = PA.attention(p, x, cfg)
    assert calls
    monkeypatch.setattr(PA, "BLOCKWISE_THRESHOLD", 64)
    y_full, _ = PA.attention(p, x, cfg)
    assert len(calls) == 1
    np.testing.assert_allclose(y_block.numpy(), y_full.numpy(), **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="Sq"):
        flash_attention(q, torch.zeros(1, 6, 2, 16), torch.zeros(1, 6, 2, 16))
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)
    meta = torch.zeros(1, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention_op(meta, meta, meta)


def test_op_is_differentiable_on_the_cpu():
    """On CPU tensors the op is the plain formula, so autograd reaches q, k
    and v (the kernel route raises instead: it has no backward)."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in qkv(np.random.RandomState(9), 1, 16, 4, 2))
    flash_attention_op(q, k, v, causal=True, window=4).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("causal,window,heads,s", [
    (False, 0, (4, 4), 48),      # hubert: bidirectional MHA
    (True, 0, (4, 2), 40),
    (True, 8, (4, 1), 48)])
def test_flash_attention_at_head_dim_80(causal, window, heads, s):
    """hubert-xlarge's head dim 80 (the kernel's third instance): the
    wrapper's plain version against the reference's Pallas kernel in
    interpret mode, which takes hd 80, and its oracle."""
    h, kv = heads
    q, k, v = qkv(np.random.RandomState(80 + s), 2, s, h, kv, hd=80)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (j_flash(jq, jk, jv, causal=causal, window=window,
                         interpret=True),
                 jref.ref_attention(jq, jk, jv, causal=causal,
                                    window=window)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
