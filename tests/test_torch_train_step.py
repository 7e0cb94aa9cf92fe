"""The port's train step (``repro_torch.launch.steps.make_train_step``) on
``gpt2-moe-smoke`` against the reference on the CPU.

The reference's own ``make_train_step`` / ``Trainer`` do not run under the
installed JAX (``ShardingTypeError`` on contracting dimensions), and
``jax.grad`` through ``models/lm.py::_run_stack`` fails, so the oracle is a
shard-free composition of the reference's own functions, layer by layer:
``embed_inputs``; per layer ``rms_norm``, ``attention(None, ...)``,
``rms_norm``, ``router_top_k_gating``, the ``core.dispatch`` backend,
``expert_ffn`` and combine (expert parallelism 1: the all-to-all is the
identity); the final ``rms_norm``, ``chunked_ce_loss``,
``jax.value_and_grad`` and ``adamw_update``.  Both sides start from the
reference's ``init_params(PRNGKey(0))`` (converted) and see the same
``SyntheticLM`` batches (seed 0, batch 4 x seq 32), AdamW lr 1e-3,
warmup 1, total 4.

Tolerances at float32: loss and grad norm rtol 1e-5, the reference's
three losses rtol 1e-6; params after the steps as ``PARAM_*`` below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.dispatch import get_backend as j_get_backend
from repro.core.gating import capacity as j_capacity
from repro.core.gating import router_top_k_gating as j_gating
from repro.core.moe import expert_ffn as j_expert_ffn
from repro.kernels.ops import resolve_backend as j_resolve
from repro.models import lm as jlm
from repro.models.attention import attention as j_attention
from repro.models.layers import rms_norm as j_rms_norm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import init_opt_state as j_init_opt_state
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

# the reference composition's losses on the three steps (xla / scatter)
LOSSES = (6.925377, 6.526284, 6.608515)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
# Adam moves each parameter by up to ~lr per step whatever its gradient's
# size, so an element whose gradient is near zero can move differently on
# the two sides after a last-bit difference: every element within a tenth
# of one step's move, and all but 0.1% of each leaf within 1e-6
PARAM_ATOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 1e-4, 1e-6, 1e-3


def _with_backend(cfg, backend):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, compute_backend=backend))


def ref_loss(cfg, params, batch, dispatch_backend):
    """The shard-free reference forward (see the module docstring)."""
    p = jlm.cast_for_compute(cfg, params)
    x = jlm.embed_inputs(cfg, p, tokens=batch["tokens"])
    b, s, d = x.shape
    m = cfg.moe
    backend = j_resolve(m.compute_backend)
    cap = j_capacity(b * s, m.n_experts, m.top_k, m.capacity_factor)
    disp, comb = j_get_backend(dispatch_backend)
    aux = jnp.zeros(())
    for gi in range(p.stack.ln1.shape[0]):
        gp = jlm._tree_idx(p.stack, gi)
        h = j_rms_norm(x, gp.ln1[0], cfg.norm_eps)
        y, _ = j_attention(None, jlm._tree_idx(gp.attn, 0), h, cfg)
        x = x + y
        h = j_rms_norm(x, gp.ln2[0], cfg.norm_eps).reshape(b * s, d)
        g = j_gating(h, gp.moe.router, m.top_k, cap, m.aux_loss_weight,
                     compute_backend=backend)
        buf = disp(h, g, m.n_experts, cap)
        out = j_expert_ffn(gp.moe.wi, gp.moe.wu, gp.moe.wo, buf,
                           cfg.ffn_type, backend)
        x = x + comb(out, g, m.n_experts, cap).reshape(b, s, d)
        aux = aux + g.aux_loss
    x = j_rms_norm(x, p.final_norm, cfg.norm_eps)
    loss = jlm.chunked_ce_loss(None, x, jlm.unembed_weight(p),
                               batch["labels"],
                               jnp.ones(batch["labels"].shape, jnp.float32))
    return loss + aux


def ref_train(cfg, params, batches, dispatch_backend, microbatches=1):
    """[(loss, grad_norm)] per step and the final params."""
    ocfg = JAdamWConfig(**OPT)

    def step(params, st, batch):
        def grads(b):
            return jax.value_and_grad(
                lambda p: ref_loss(cfg, p, b, dispatch_backend))(params)
        n = batch["tokens"].shape[0] // microbatches
        loss, g = 0.0, None
        for i in range(microbatches):
            l, gi = grads({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            loss = loss + l
            g = gi if g is None else jax.tree.map(jnp.add, g, gi)
        g = jax.tree.map(lambda a: a / microbatches, g)
        params, st, om = j_adamw_update(params, g, st, ocfg)
        return params, st, loss / microbatches, om["grad_norm"]

    step = jax.jit(step)
    st = j_init_opt_state(params, ocfg)
    out = []
    for batch in batches:
        params, st, loss, gn = step(
            params, st, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(loss), float(gn)))
    return out, params


def port_train(cfg, params, batches, dispatch_backend, microbatches=1):
    ocfg = AdamWConfig(**OPT)
    step = make_train_step(cfg, ocfg, dispatch_backend=dispatch_backend,
                           microbatches=microbatches)
    st = init_opt_state(params, ocfg)
    out = []
    for batch in batches:
        params, st, m = step(params, st, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
        assert set(m) == {"loss", "aux_loss", "grad_norm", "lr"}
    return out, params


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("gpt2-moe-smoke")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    ds = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                global_batch=4, seed=0))
    return jcfg, jparams, [ds.batch(i) for i in range(3)]


@pytest.mark.parametrize("backend,dispatch_backend,n_steps,mb", [
    ("xla", "scatter", 3, 1), ("xla", "einsum", 3, 1),
    ("pallas", "pallas", 2, 1), ("xla", "einsum", 2, 2)])
def test_train_step_matches_reference_composition(setup, backend,
                                                  dispatch_backend, n_steps,
                                                  mb):
    jcfg, jparams, batches = setup
    jcfg = _with_backend(jcfg, backend)
    cfg = _with_backend(get_config("gpt2-moe-smoke"), backend)
    want, jp = ref_train(jcfg, jparams, batches[:n_steps], dispatch_backend,
                         mb)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    got, p = port_train(cfg, params, batches[:n_steps], dispatch_backend, mb)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    if mb == 1:
        np.testing.assert_allclose([l for l, _ in got], LOSSES[:n_steps],
                                   rtol=1e-6)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        to_reference(p, jax.tree.map(np.asarray, jp)))
    want_leaves = jax.tree_util.tree_leaves(jp)
    assert len(got_leaves) == len(want_leaves) > 10
    for (path, g), w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.mean(np.abs(g - w) > PARAM_TIGHT) <= PARAM_TIGHT_SHARE, \
            jax.tree_util.keystr(path)


def test_train_step_takes_the_schedule_compression_and_shortcut():
    """What used to need expert parallelism runs on one rank: a schedule
    with bf16 compression gives the plain step's gradients rounded to bf16
    (no rank to reduce over), and the ScMoE shortcut (the shared FFN run
    inside the MoE layer, summed into the combine) gives the loss of the
    same weights as a shared expert added after the layer."""
    cfg = _with_backend(get_config("gpt2-moe-smoke"), "xla")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    sc = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          shortcut=True))
    gen = torch.Generator()
    gen.manual_seed(0)
    from repro_torch.models.lm import init_params
    from repro_torch.tree import tree_leaves
    params = init_params(sc, gen, device="cpu")
    plain, loss, _, _ = make_train_step(sc).reduced_grads(params, batch)
    got, loss16, _, _ = make_train_step(
        sc, schedule="priority", grad_compression="bf16").reduced_grads(
            params, batch)
    for g, p in zip(tree_leaves(got), tree_leaves(plain)):
        torch.testing.assert_close(g, p.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
    shared = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shared_expert=True))
    _, loss_shared, _, _ = make_train_step(shared).reduced_grads(params,
                                                                 batch)
    assert float(loss) == pytest.approx(float(loss_shared), rel=1e-6)
    assert float(loss16) == float(loss)
    assert tree_leaves(got)[-1].abs().sum() > 0


def test_grad_compression_without_a_schedule_raises():
    with pytest.raises(ValueError, match="requires an explicit schedule"):
        make_train_step(get_config("gpt2-moe-smoke"),
                        grad_compression="bf16")
