"""The dense-sharded path (``launch.sharding``'s specs and ``Layout``)
on gloo ranks, against the reference's shard-free functions and the port
with no mesh, at float32.

One spawn of 4 ranks (``_torch_ranks.tp_body``) runs every case:
``forward_train``'s loss and every gradient (reduced, gathered back by the
specs) and the global gradient norm on a (2, 2) mesh for qwen3-8b-smoke
with 2 kv heads (GQA whose kv heads split), granite-34b-smoke (MQA: k and
v computed whole, each rank keeping the one kv head) and qwen3-8b-smoke
with 3 heads (they do not split over 2 ranks: the weights are gathered and
attention computed whole), qwen3-8b-smoke with a sliding window of 4, and
mixtral-8x22b-smoke on (1, 2, 2) (data, model, tp): its experts' hidden
dims sliced over `tp`, the FFN's output summed there, forward and
backward; then each case's prefill and six decode steps over the
sequence-sharded cache, which write the slots of more than one rank (the
owner's write, the key positions' offset, the combine of two ranks' valid
keys; with the window, a ring that wraps from one rank's slice to
another's); and a dense-sharded trainer on (2, 2), whose checkpoint a
trainer with no mesh resumes.  Losses within
1e-5, tensors within 1e-4 (the no-mesh side is held to the reference by
the reference's forward here and by ``tests/test_torch_dense.py``,
``test_torch_mixtral.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import share_cores
from _torch_ranks import (DECODE_SLOTS, DECODE_STEPS, TP_CASES, _tokens,
                          _trainer, full_params, run_ranks, tp_body)
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import to_reference
from repro_torch.tree import tree_items

share_cores()

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(atol=1e-5, rtol=1e-5)
NAMES = [c[0] for c in TP_CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    root = str(tmp / "ckpt")
    return run_ranks(tp_body, 4, tmp, root), root


def configs(name):
    _, arch, shape, over = next(c for c in TP_CASES if c[0] == name)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if over:
        jcfg, cfg = (dataclasses.replace(c, **over) for c in (jcfg, cfg))
    if cfg.moe.enabled:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0, aux_loss_weight=0.0))
            for c in (jcfg, cfg))
    return jcfg, cfg


def reference(name):
    """(reference config, its params: the port's seed-0 params)."""
    jcfg, cfg = configs(name)
    like = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    jp = to_reference(full_params(cfg), like)
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp)


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_gradients_match(ranks, name):
    out = [r[name] for r in ranks[0]]
    jcfg, cfg, jp = reference(name)
    b, s = 4, 16
    batch = {"tokens": _tokens(cfg, b, s, 1), "labels": _tokens(cfg, b, s, 2)}
    want = jlm.forward_train(None, jcfg, jp,
                             {k: jnp.asarray(v.numpy()) for k, v in
                              batch.items()}, lina=False)
    r0 = out[0]
    # every rank logs the global loss: its data shard's mean over the ranks
    for r in out:
        np.testing.assert_allclose(r["loss"], r0["want_loss"], **LOSS)
    np.testing.assert_allclose(r0["want_loss"], float(want.loss), **LOSS)
    assert len(r0["grads"]) == len(r0["want"])
    for i, (g, w) in enumerate(zip(r0["grads"], r0["want"])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg=f"leaf {i}", **TOL)
    norm = float(np.sqrt(sum(float(np.sum(np.square(w.astype(np.float64))))
                             for w in r0["want"])))
    for r in out:
        np.testing.assert_allclose(r["norm"], norm, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_over_the_sequence_sharded_cache(ranks, name):
    out = [r[name] for r in ranks[0]]
    jcfg, cfg, jp = reference(name)
    b, s = 4, 16
    toks = _tokens(cfg, b, s, 1).numpy()
    want = np.asarray(jlm.forward_prefill(
        None, jcfg, jp, {"tokens": jnp.asarray(toks)}).logits)
    jc = jlm.init_cache(jcfg, b, DECODE_SLOTS, jnp.float32)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(None, jcfg, p, c, t))
    steps = []
    for t in range(DECODE_STEPS):
        jl, jc, _ = jstep(jp, jc, jnp.asarray(toks[:, t]))
        steps.append(np.asarray(jl))
    n_mp = 2 if name != "mixtral" else 4
    for r in out:
        rows = r["rows"]
        np.testing.assert_allclose(r["prefill"], want[rows], **TOL)
        for t in range(DECODE_STEPS):
            np.testing.assert_allclose(r["decode"][t], steps[t][rows],
                                       err_msg=f"step {t}", **TOL)
        # the cache holds this rank's rows and its slice of the slots
        slots = min(DECODE_SLOTS, cfg.sliding_window or DECODE_SLOTS)
        assert r["cache_shape"][2:4] == (len(rows), slots // n_mp)


def test_a_trainer_saved_on_a_mesh_resumes_with_none(ranks, tmp_path):
    out, root = ranks
    cfg = get_config("qwen3-8b-smoke")
    plain = _trainer(cfg, str(tmp_path / "plain"), None,
                     schedule="priority+partition", partition_bytes=4096)
    plain.run()
    got = [r["trainer"]["losses"] for r in out]
    for losses in got:
        np.testing.assert_allclose(
            losses, [m["loss"] for m in plain.metrics_log], **LOSS)
    # the checkpoint holds the full tree: a mesh-free trainer restores it
    # bit for bit and trains on from it
    resumed = _trainer(cfg, root, None, steps=6,
                       schedule="priority+partition", partition_bytes=4096)
    like = resumed._full_state()
    step, state = resumed._restore(like)
    assert step == 4
    saved = out[0]["trainer"]["state"]
    have = dict(tree_items(state))
    assert have.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(have[k].numpy(), v, err_msg=k)
    resumed.run()
    assert [m["step"] for m in resumed.metrics_log] == [4, 5]
    assert all(np.isfinite(m["loss"]) for m in resumed.metrics_log)
