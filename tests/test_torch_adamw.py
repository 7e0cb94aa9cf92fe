"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``) on the CPU: the same parameter tree and gradients
(numpy, seeded) through several steps with warmup, an active global-norm
clip and weight decay; the schedule and the clip on their own.

Tolerance: rtol = 1e-5, atol = 1e-7 at float32 (the same fp32 arithmetic
in another framework; pow and cos may differ in the last bit).  The step
counter is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def _tree(rng, scale=1.0):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _np(tree):
    return {k: np.asarray(v, np.float32) if not torch.is_tensor(v)
            else v.float().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(state_dtype):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, weight_decay=0.1,
              grad_clip=1.0, state_dtype=state_dtype)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st, jst = adamw.init_opt_state(p, cfg), jadamw.init_opt_state(jp, jcfg)
    clipped = 0
    for step in range(6):
        grads = _tree(rng, scale=3.0 if step % 2 else 0.1)
        p, st, m = adamw.adamw_update(
            p, {k: torch.from_numpy(v) for k, v in grads.items()}, st, cfg)
        jp, jst, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst, jcfg)
        assert int(st.step) == int(jst.step) == step + 1
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        clipped += float(m["grad_norm"]) > cfg.grad_clip
        for tree, jtree in ((p, jp), (st.m, jst.m), (st.v, jst.v)):
            got, want = _np(tree), _np(jtree)
            for k in SHAPES:
                np.testing.assert_allclose(got[k], want[k], **TOL)
        assert st.m["a"].dtype == adamw.DTYPES[state_dtype]
    assert 0 < clipped < 6        # the clip was active on some steps only


def test_cosine_schedule_matches_reference():
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=20)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=20)
    for s in range(0, 25):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                        cfg)),
            float(jadamw.cosine_schedule(jnp.asarray(s, jnp.int32), jcfg)),
            **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.RandomState(4))
    got, gn = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    want, jgn = jadamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(gn), float(jgn), **TOL)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_update_is_functional():
    rng = np.random.RandomState(1)
    p = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    before = {k: v.clone() for k, v in p.items()}
    cfg = adamw.AdamWConfig(warmup_steps=1)
    st = adamw.init_opt_state(p, cfg)
    adamw.adamw_update(p, {k: torch.ones_like(v) for k, v in p.items()}, st,
                       cfg)
    for k in SHAPES:
        assert torch.equal(p[k], before[k])
    assert int(st.step) == 0 and not st.m["a"].any()
