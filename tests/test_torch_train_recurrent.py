"""Training the RWKV6 and hybrid Mamba2 families in the port
(``rwkv6-1.6b-smoke``, ``zamba2-1.2b-smoke``) against the reference on
the CPU: ``models.lm.forward_train``'s loss and every gradient leaf
against ``jax.grad`` of the reference's ``forward_train`` (with and
without remat), three AdamW steps of ``launch.steps.make_train_step``
against ``jax.value_and_grad`` of the reference's ``forward_train`` and
its ``adamw_update`` (a shard-free composition of the reference's own
functions, as ``test_torch_train_step.py``), ``launch.train --device
cpu`` with a bitwise resume, and the shared block's plain attention in
training.

Weights are the reference's ``init_params(PRNGKey(0))`` through
``convert.from_reference``; rwkv6's bonus u is set to random values (the
model starts it at zero, which would leave its gradient's term
untested).  zamba2 is held to the reference with a_log = log linspace(1,
4): at the model's own init (A up to 16) the reference's gradient is NaN
(``models/ssm.py``'s ``ssd_chunked`` masks exp(L_t - L_s) after forming
it above the diagonal, where it overflows), and
``test_zamba2_gradient_is_finite_where_the_reference_is_nan`` records
that.  Batches are ``SyntheticLM``'s (seed 0, 2 x 32 tokens).  The loss
within 1e-5 and every gradient leaf within 1e-4, norm-wise; after three
AdamW steps the losses and grad norms within 1e-5 and the params as
``test_torch_train_step.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import init_opt_state as j_init_opt_state
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as attention_mod
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_items, tree_leaves, tree_map, \
    tree_unflatten_like
from _torch_threads import share_cores

share_cores()

ARCHS = ("rwkv6-1.6b-smoke", "zamba2-1.2b-smoke")
LOSS_REL, GRAD_REL = 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
PARAM_ATOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 1e-4, 1e-6, 1e-3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def ref_params(jcfg, a_log_top=4.0):
    """The reference's init, with rwkv6's u random and zamba2's a_log =
    log linspace(1, ``a_log_top``) (None: the model's own)."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    st = jp.stack
    if hasattr(st, "blocks"):
        u = np.random.default_rng(5).standard_normal(st.blocks.u.shape)
        jp = jp._replace(stack=st._replace(blocks=st.blocks._replace(
            u=jnp.asarray(u * 0.5, st.blocks.u.dtype))))
    elif a_log_top is not None:
        h = st.mamba.a_log.shape[-1]
        a_log = jnp.broadcast_to(jnp.log(jnp.linspace(1.0, a_log_top, h)),
                                 st.mamba.a_log.shape)
        jp = jp._replace(stack=st._replace(mamba=st.mamba._replace(
            a_log=a_log.astype(st.mamba.a_log.dtype))))
    return jp


def batches(jcfg, n):
    ds = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                global_batch=2, seed=0))
    return [ds.batch(i) for i in range(n)]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(port cfg, reference cfg, reference params, batches, the jitted
    reference value_and_grad)."""
    jcfg = j_get_config(request.param)

    def loss(p, b):
        return jlm.forward_train(None, jcfg, p, b)[0]
    return (get_config(request.param), jcfg, ref_params(jcfg),
            batches(jcfg, 3), jax.jit(jax.value_and_grad(loss)))


def port_grads(cfg, params, batch):
    ps = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = lm.forward_train(cfg, ps, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(out.loss, tree_leaves(ps))
    return out, tree_unflatten_like(params, grads)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_matches_reference_grad(setup, remat):
    cfg, jcfg, jp, data, vg = setup
    jl, jg = vg(jp, {k: jnp.asarray(v) for k, v in data[0].items()})
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    out, g = port_grads(dataclasses.replace(cfg, remat=remat), params,
                        data[0])
    assert out.expert_choices is None and float(out.aux_loss) == 0.0
    assert rel(float(out.loss.detach()), float(jl)) <= LOSS_REL
    got = jax.tree_util.tree_leaves_with_path(
        to_reference(g, jax.tree.map(np.asarray, jg)))
    want = jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want) > 10
    for (path, a), b in zip(got, want):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(a).all(), name
        assert rel(a, b) <= GRAD_REL, (name, rel(a, b))


def test_three_adamw_steps_match_reference_composition(setup):
    cfg, jcfg, jp, data, vg = setup
    jocfg = JAdamWConfig(**OPT)
    jst = j_init_opt_state(jp, jocfg)
    want, p_ref = [], jp
    for b in data:
        loss, g = vg(p_ref, {k: jnp.asarray(v) for k, v in b.items()})
        p_ref, jst, om = j_adamw_update(p_ref, g, jst, jocfg)
        want.append((float(loss), float(om["grad_norm"])))
    ocfg = AdamWConfig(**OPT)
    step = make_train_step(cfg, ocfg)
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    st = init_opt_state(params, ocfg)
    got = []
    for b in data:
        params, st, m = step(params, st, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
        assert float(m["aux_loss"]) == 0.0
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        to_reference(params, jax.tree.map(np.asarray, p_ref)))
    for (path, g), w in zip(got_leaves, jax.tree_util.tree_leaves(p_ref)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.mean(np.abs(g - w) > PARAM_TIGHT) <= PARAM_TIGHT_SHARE, \
            jax.tree_util.keystr(path)


def test_zamba2_gradient_is_finite_where_the_reference_is_nan():
    """At zamba2's own init (A = linspace(1, 16)) the reference's
    ``jax.grad`` of ``forward_train`` has NaN leaves; the port's is finite
    in every leaf."""
    jcfg = j_get_config("zamba2-1.2b-smoke")
    jp = ref_params(jcfg, a_log_top=None)
    batch = batches(jcfg, 1)[0]
    _, jg = jax.value_and_grad(
        lambda p: jlm.forward_train(None, jcfg, p, {
            k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    assert any(np.isnan(np.asarray(a)).any()
               for a in jax.tree_util.tree_leaves(jg))
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    out, g = port_grads(get_config("zamba2-1.2b-smoke"), params, batch)
    assert np.isfinite(float(out.loss))
    assert all(torch.isfinite(a).all() for a in tree_leaves(g))


def test_shared_attention_is_plain_in_training(monkeypatch):
    """zamba2's shared block takes the flash op in prefill (the kernel
    route) and the plain attention in training (the flash kernel has no
    backward)."""
    cfg = get_config("zamba2-1.2b-smoke")
    jp = ref_params(j_get_config(cfg.name))
    params = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    calls = []

    def flash(*a, **kw):
        calls.append(1)
        raise AssertionError("the flash op was called")
    monkeypatch.setattr(attention_mod, "flash_attention_op", flash)
    batch = batches(j_get_config(cfg.name), 1)[0]
    port_grads(cfg, params, batch)
    assert not calls
    with pytest.raises(AssertionError, match="flash op was called"):
        with torch.inference_mode():
            lm.forward_prefill(cfg, params,
                               {"tokens": torch.from_numpy(batch["tokens"])})


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_and_resumes_bitwise(arch, tmp_path):
    """``launch.train --device cpu``: 4 straight steps against 2 +
    injected failure + restart + 2, the params and optimizer state
    bitwise equal."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "4", "--batch",
            "2", "--seq", "32", "--ckpt-every", "2"]
    straight = train.run(argv + ["--ckpt-dir", str(tmp_path / "a")])
    log = straight["trainer"].metrics_log
    assert len(log) == 4 and all(np.isfinite(r["loss"]) for r in log)
    assert all(r["aux_loss"] == 0.0 for r in log)
    cfg, dcfg, ocfg, tcfg = train.configs(train.parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "b")]))
    failing = Trainer(cfg, dcfg, ocfg,
                      dataclasses.replace(tcfg, fail_at_step=2))
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        failing.run()
    resumed = Trainer(cfg, dcfg, ocfg, tcfg)
    got = resumed.run()
    want = straight["state"]
    for (k, a), (_, b) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(a, b), k
    assert [r["loss"] for r in failing.metrics_log + resumed.metrics_log] \
        == [r["loss"] for r in log]
