"""Gating and the weighted-split helpers of the port against the JAX
reference on the CPU, on the same numpy inputs: ``router_top_k_gating``
(both of the port's routes against the reference's plain path and its
interpret-mode Pallas path), ``capacity`` / ``slot_capacity``, the
placement plan and its route weights, ``balanced_route_fractions`` and
``integer_route_weights`` (tensor and numpy forms), ``uniform_route_weight``.

Integer outputs exact; floats within atol = rtol = 1e-4 (float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gating as jgating
from repro.core import serving as jserving
from repro.core.placement import plan_placement as j_plan_placement
from repro.core.placement import route_weights as j_route_weights
from repro_torch.core import gating, serving
from repro_torch.core.placement import plan_placement, route_weights

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_router_top_k_gating_matches_reference(k, backend):
    rng = np.random.RandomState(11 + k)
    t, d, e = 40, 32, 8
    x = rng.randn(t, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    cap = 4 * k              # below the mean load: some choices drop
    got = gating.router_top_k_gating(torch.from_numpy(x),
                                      torch.from_numpy(router), k, cap,
                                      compute_backend=backend)
    for jb in ("xla", "pallas"):
        want = jgating.router_top_k_gating(jnp.asarray(x),
                                           jnp.asarray(router), k, cap,
                                           compute_backend=jb)
        for f in ("expert_idx", "position", "dropped"):
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
        for f in ("gate_weights", "aux_loss", "router_probs"):
            np.testing.assert_allclose(_np(getattr(got, f)),
                                       np.asarray(getattr(want, f)), **TOL)
    assert _np(got.dropped).any(), "capacity should drop some choices"


def test_capacity_matches_reference():
    for n in (1, 7, 64, 255, 4096):
        for e in (4, 16):
            for k in (1, 2):
                for cf in (1.0, 1.25):
                    assert gating.capacity(n, e, k, cf) == \
                        jgating.capacity(n, e, k, cf)
    for cap in (8, 24, 48):
        for r in (1, 2, 3, 4):
            assert serving.slot_capacity(cap, r) == \
                jserving.slot_capacity(cap, r)


def _plan(e, n_dev, seed):
    rng = np.random.RandomState(seed)
    pop = rng.dirichlet(np.full(e, 0.5))
    return plan_placement(pop, n_dev, 4), j_plan_placement(pop, n_dev, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_split_helpers_match_reference(seed):
    e, n_dev = 8, 8
    plan, jplan = _plan(e, n_dev, seed)
    np.testing.assert_array_equal(plan.slot_expert, jplan.slot_expert)
    rw = route_weights(plan)
    np.testing.assert_array_equal(rw, j_route_weights(jplan))
    counts = np.random.RandomState(seed).randint(0, 30, (e,)).astype(
        np.int32)
    jf = jserving.balanced_route_fractions(
        jnp.asarray(counts), jnp.asarray(rw), jnp.asarray(plan.replica_of),
        jnp.asarray(plan.n_replicas), n_dev, 4)
    tf = serving.balanced_route_fractions(
        torch.from_numpy(counts), torch.from_numpy(rw),
        torch.from_numpy(plan.replica_of), torch.from_numpy(plan.n_replicas),
        n_dev, 4)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-6)
    nf = serving.balanced_route_fractions(counts, rw, plan.replica_of,
                                          plan.n_replicas, n_dev, 4)
    np.testing.assert_array_equal(nf, jserving.balanced_route_fractions(
        counts, rw, plan.replica_of, plan.n_replicas, n_dev, 4, xp=np))
    for slot_cap in (8, 24):
        jw = jserving.integer_route_weights(jnp.asarray(counts), jf,
                                            jnp.asarray(plan.n_replicas),
                                            slot_cap)
        tw = serving.integer_route_weights(
            torch.from_numpy(counts), torch.from_numpy(np.array(jf)),
            torch.from_numpy(plan.n_replicas), slot_cap)
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
        np.testing.assert_array_equal(
            serving.integer_route_weights(counts, nf, plan.n_replicas,
                                          slot_cap),
            jserving.integer_route_weights(counts, nf, plan.n_replicas,
                                           slot_cap, xp=np))


def test_uniform_route_weight_matches_reference():
    plan, _ = _plan(8, 8, 9)
    got = serving.uniform_route_weight(torch.from_numpy(plan.replica_of),
                                       torch.from_numpy(plan.n_replicas))
    want = jserving.uniform_route_weight(plan.replica_of, plan.n_replicas)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-7)
