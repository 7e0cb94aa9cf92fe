"""The plan-honoring serving layer of the port against the JAX reference on
the CPU, on the same numpy inputs: ``serve_moe_layer`` in both route modes
and both of the port's routes, including a plan whose dead devices were
masked by ``mask_dead_route_weights``, and the numpy telemetry mirror; on
the kernel route the expert FFN reads the hosted experts' weights in place
through the slot -> expert index and skips the slot rows nothing was
routed to.

Integer outputs exact; floats within atol = rtol = 1e-4 (float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import gating as jgating
from repro.core import serving as jserving
from repro.core.moe import MoEParams as JMoEParams
from repro.core.placement import plan_placement as j_plan_placement
from repro_torch.configs.base import MoEConfig
from repro_torch.core import moe, serving
from repro_torch.core.moe import MoEParams
from repro_torch.core.placement import plan_placement, route_weights

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _plan(e, n_dev, seed):
    rng = np.random.RandomState(seed)
    pop = rng.dirichlet(np.full(e, 0.5))
    return plan_placement(pop, n_dev, 4), j_plan_placement(pop, n_dev, 4)


def _moe_case(seed, d=32, f=64, e=8, t=48):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    wi = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    wo = (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32)
    return x, router, wi, wo


@pytest.mark.parametrize("route_mode", ["weighted", "round_robin"])
@pytest.mark.parametrize("dead", [(), (1, 5)])
def test_serve_moe_layer_matches_reference(route_mode, dead):
    e, n_dev, k = 8, 8, 1
    x, router, wi, wo = _moe_case(3)
    plan, _ = _plan(e, n_dev, 4)
    rw = route_weights(plan)
    if dead:
        rw = np.asarray(serving.mask_dead_route_weights(
            rw, plan.replica_of, plan.max_pack, dead), np.float32)
        np.testing.assert_allclose(rw, np.asarray(
            jserving.mask_dead_route_weights(
                route_weights(plan), plan.replica_of, plan.max_pack, dead,
                xp=np)), atol=1e-7)
    min_rep = int(plan.n_replicas.min())
    jcfg = JMoEConfig(n_experts=e, top_k=2, d_ff=64)
    want = jserving.serve_moe_layer(
        None, jnp.asarray(x), JMoEParams(jnp.asarray(router),
                                         jnp.asarray(wi), None,
                                         jnp.asarray(wo)),
        jcfg, jserving.PlanArrays(jnp.asarray(plan.slot_expert),
                                  jnp.asarray(plan.replica_of),
                                  jnp.asarray(plan.n_replicas),
                                  jnp.asarray(rw)),
        ffn_type="gelu", top_k=k, min_replicas=min_rep,
        route_mode=route_mode)
    tparams = MoEParams(*(torch.from_numpy(a) if a is not None else None
                          for a in (router, wi, None, wo)))
    tplan = serving.PlanArrays(*(torch.from_numpy(np.asarray(a)) for a in
                                 (plan.slot_expert, plan.replica_of,
                                  plan.n_replicas, rw)))
    for backend in ("xla", "pallas"):
        cfg = MoEConfig(n_experts=e, top_k=2, d_ff=64,
                        compute_backend=backend)
        got = serving.serve_moe_layer(torch.from_numpy(x), tparams, cfg,
                                      tplan, ffn_type="gelu", top_k=k,
                                      min_replicas=min_rep,
                                      route_mode=route_mode)
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), **TOL)
    # the numpy telemetry mirror agrees with the reference's
    cap = jgating.capacity(x.shape[0], e, k, jcfg.capacity_factor)
    slot_cap = serving.slot_capacity(cap, min_rep)
    idx = np.asarray(want[1])
    valid = np.arange(x.shape[0]) < 40
    hplan = serving.PlanArrays(plan.slot_expert, plan.replica_of,
                               plan.n_replicas, rw)
    jhplan = jserving.PlanArrays(plan.slot_expert, plan.replica_of,
                                 plan.n_replicas, rw)
    np.testing.assert_array_equal(
        serving.replica_token_counts(idx, hplan, cap, slot_cap, valid=valid,
                                     route_mode=route_mode),
        jserving.replica_token_counts(idx, jhplan, cap, slot_cap,
                                      valid=valid, route_mode=route_mode))


@pytest.mark.parametrize("ffn_type", ["gelu", "swiglu"])
@pytest.mark.parametrize("route_mode", ["weighted", "round_robin"])
@pytest.mark.parametrize("dead", [(), (1, 5)])
def test_kernel_route_reads_hosted_weights_in_place(monkeypatch, ffn_type,
                                                    route_mode, dead):
    """The kernel route hands the FFN the unexpanded [E, d, f] weights with
    the plan's slot -> expert index (no [n_slots, d, f] copy) and each
    slot's highest routed row + 1, and still matches the reference."""
    e, n_dev, k = 8, 8, 2
    x, router, wi, wo = _moe_case(5)
    wu = (np.random.RandomState(9).randn(*wi.shape)
          / np.sqrt(wi.shape[1])).astype(np.float32) \
        if ffn_type == "swiglu" else None
    plan, _ = _plan(e, n_dev, 6)
    rw = route_weights(plan)
    if dead:
        rw = np.asarray(serving.mask_dead_route_weights(
            rw, plan.replica_of, plan.max_pack, dead), np.float32)
    min_rep = int(plan.n_replicas.min())
    jcfg = JMoEConfig(n_experts=e, top_k=k, d_ff=64)
    want = jserving.serve_moe_layer(
        None, jnp.asarray(x), JMoEParams(
            *(None if a is None else jnp.asarray(a)
              for a in (router, wi, wu, wo))),
        jcfg, jserving.PlanArrays(jnp.asarray(plan.slot_expert),
                                  jnp.asarray(plan.replica_of),
                                  jnp.asarray(plan.n_replicas),
                                  jnp.asarray(rw)),
        ffn_type=ffn_type, top_k=k, min_replicas=min_rep,
        route_mode=route_mode)
    calls = []
    real = moe.grouped_ffn_op

    def spy(x_, wi_, wu_, wo_, ffn, **kw):
        calls.append((x_.shape, wi_.shape, wo_.shape, kw))
        return real(x_, wi_, wu_, wo_, ffn, **kw)
    monkeypatch.setattr(moe, "grouped_ffn_op", spy)
    cfg = MoEConfig(n_experts=e, top_k=k, d_ff=64, compute_backend="pallas")
    tplan = serving.PlanArrays(*(torch.from_numpy(np.asarray(a)) for a in
                                 (plan.slot_expert, plan.replica_of,
                                  plan.n_replicas, rw)))
    got = serving.serve_moe_layer(
        torch.from_numpy(x), MoEParams(*(None if a is None else
                                         torch.from_numpy(a)
                                         for a in (router, wi, wu, wo))),
        cfg, tplan, ffn_type=ffn_type, top_k=k, min_replicas=min_rep,
        route_mode=route_mode)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), **TOL)

    (xs, wis, wos, kw), = calls
    n_slots = plan.slot_expert.size
    assert wis == wi.shape and wos == wo.shape       # in place, no gather
    np.testing.assert_array_equal(_np(kw["group_expert"]),
                                  plan.slot_expert.reshape(-1))
    assert kw["group_expert"].dtype == torch.int32
    # group_rows: one past each slot's highest routed buffer row
    cap = jgating.capacity(x.shape[0], e, k, jcfg.capacity_factor)
    slot_cap = serving.slot_capacity(cap, min_rep)
    assert xs == (n_slots, slot_cap, x.shape[1])
    routed = serving.replica_token_counts(
        np.asarray(want[1]), serving.PlanArrays(
            plan.slot_expert, plan.replica_of, plan.n_replicas, rw), cap,
        slot_cap, route_mode=route_mode)
    rows = _np(kw["group_rows"])
    assert rows.dtype == np.int32 and (rows >= routed).all()
    assert (rows <= slot_cap).all() and (rows[routed == 0] == 0).all()
    if route_mode == "weighted":         # rows fill each slot from 0
        np.testing.assert_array_equal(rows, routed)


def test_slot_rows_takes_the_highest_routed_row():
    rows = torch.tensor([[3, -1], [9, 0], [-1, 1], [12, 4]], dtype=torch.int32)
    got = serving.slot_rows(rows, 4, 4)    # slots 0..3 of 4 rows
    np.testing.assert_array_equal(got.numpy(), [4, 1, 2, 1])
