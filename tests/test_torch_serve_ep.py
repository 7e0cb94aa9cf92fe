"""The port's serving on an expert-parallel mesh against the reference's on
the same mesh shape, on the CPU.

``serve_moe_layer`` with a ``mesh`` runs on 8 spawned gloo ranks, a (2, 4)
``(data, model)`` mesh, against the reference's on an 8-device CPU mesh,
over the cases of ``_torch_ranks.SERVE_CASES``: weighted and round-robin
routing, top-1 and top-2, gelu and swiglu, the plain ("xla") and kernel
("pallas": the kernels' plain versions here, the interpret-mode Pallas
kernels in the reference) routes, n_dev = ep and n_dev = 2 * ep, 63 tokens
(which do not tile dp, so every rank routes all of them), min_replicas 2,
cap_override and one dead device masked by ``mask_dead_route_weights``, at
a capacity factor (``SERVE_CF``) at which a token shard drops tokens.
Every rank returns the global outputs; ids exact, y within 1e-5, router
probabilities within 1e-6.

``MoEServer`` runs on a (2, 2) mesh with the reference's weights against
the reference's ``MoEServer`` on a (2, 2) mesh: the profile,
``serve_batch``, a prefill and two decode steps (logits within 1e-5, path
ids and stats' integers equal).  Then ``simulate`` replays a trace on the
same ranks with one rank slowed in every dispatch: it must finish, and
every rank must return the same requests, tokens and stamps.

``stack_plan_arrays``, ``dp_shard_count`` and ``replica_token_counts``
with ``dp_shards`` are held against the reference's.

The reference runs once (module-scoped subprocess with
``--xla_force_host_platform_device_count=8``, every output in an
``.npz``); the port's ranks are spawned once per mesh shape.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import (SERVE_CASES, SERVE_CF, SLOW_S, run_ranks,
                          serve_layer_body, serve_server_body)
from repro.core import serving as jserving
from repro_torch.core import serving
from repro_torch.core.placement import (plan_from_replicas, plan_placement,
                                        route_weights)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, D, F = 8, 64, 128
Y_ATOL, PROB_ATOL = 1e-5, 1e-6

REF = """
import sys, json
import numpy as np, jax, jax.numpy as jnp
import torch
from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.core.moe import MoEParams
from repro.core.serving import (PlanArrays, dp_shard_count,
                                serve_moe_layer, stack_plan_arrays)
from repro.data import DataConfig, SyntheticLM
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import lm as jlm
from repro.runtime.server import MoEServer, profile_from_training
from repro_torch.convert import from_reference
from repro_torch.tree import tree_items
inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
out = {}
mesh = make_mesh((2, 4), ("data", "model"))
out["dp_shard_count"] = np.asarray([dp_shard_count(mesh, n)
                                    for n in (64, 63, 2)]
                                   + [dp_shard_count(None, 64)])
for name, (route, k, ffn, backend, n_dev, n_tok, _, cap, _) in cases.items():
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff=128,
                    capacity_factor=float(sys.argv[5]),
                    compute_backend=backend)
    params = MoEParams(inp["router"], inp["wi"],
                       inp["wu"] if ffn == "swiglu" else None, inp["wo"])
    plan = PlanArrays(*(jnp.asarray(inp[f"{name}/{f}"]) for f in (
        "slot_expert", "replica_of", "n_replicas", "route_weight")))
    min_rep = int(inp[f"{name}/n_replicas"].min())
    fn = jax.jit(lambda x, p, pl: serve_moe_layer(
        mesh, x, p, cfg, pl, ffn_type=ffn, top_k=k, min_replicas=min_rep,
        cap_override=cap, route_mode=route))
    with mesh_context(mesh):
        y, eidx, probs = fn(inp["x"][:n_tok], params, plan)
    out[name + "/y"] = np.asarray(y)
    out[name + "/eidx"] = np.asarray(eidx)
    out[name + "/probs"] = np.asarray(probs)
st = stack_plan_arrays([PlanArrays(*(jnp.asarray(inp[f"stack{i}/{f}"])
                                     for f in ("slot_expert", "replica_of",
                                               "n_replicas",
                                               "route_weight")))
                        for i in range(3)])
for f, a in zip(PlanArrays._fields, st):
    out["stacked/" + f] = np.asarray(a)

# MoEServer on a (2, 2) mesh
mesh = make_mesh((2, 2), ("data", "model"))
jcfg = get_config("gpt2-moe-smoke")
jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
np_params = jax.tree.map(np.asarray, jparams)
np.savez(sys.argv[4], **{p: a.numpy() for p, a in
                         tree_items(from_reference(np_params, device="cpu"))})
ds = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                            global_batch=4, seed=0))
prof = profile_from_training(jcfg, jparams, (ds.batch(i) for i in range(3)),
                             mesh=mesh)
out["srv/counts"] = prof.counts
srv = MoEServer(jcfg, jparams, prof, mesh=mesh)


def put(tag, res, path):
    out[tag + "/logits"] = np.asarray(res.logits)
    out[tag + "/path"] = np.asarray(path)
    for i, s in enumerate(res.stats):
        out[f"{tag}/stats{i}/replica_load"] = np.asarray(s.replica_load)
        out[f"{tag}/stats{i}/flags"] = np.asarray(
            [s.layer, s.finetuned, s.est_accurate, s.plan_reused,
             s.n_tokens])
        for f in ("est_pop", "actual_pop", "device_load"):
            out[f"{tag}/stats{i}/{f}"] = np.asarray(getattr(s, f))


r = srv.serve_batch(inp["serve_tokens"])
put("srv/serve", r, r.path_ids)
lengths = inp["lengths"]
pre = srv.prefill_batch(inp["tokens"], lengths=lengths,
                        path_init=inp["path_init"],
                        cache_len=inp["tokens"].shape[1] + 2)
put("srv/prefill", pre, pre.path_ids)
b = lengths.shape[0]
state = pre.path_ids[np.arange(b), np.maximum(lengths - 1, 0)]
cache, nxt = pre.cache, inp["next"]
for i in range(2):
    d = srv.decode_batch(nxt, cache, state, valid=lengths > 0)
    put(f"srv/decode{i}", d, d.path_state)
    cache, state = d.cache, d.path_state
    nxt = np.argmax(np.asarray(d.logits), axis=-1)
np.savez(sys.argv[2], **out)
"""


def _plan_tables(name, rng):
    route, k, ffn, backend, n_dev, n_tok, reps, cap, dead = SERVE_CASES[name]
    pop = rng.dirichlet(np.full(E, 0.5))
    if reps is None:
        plan = plan_placement(pop, n_dev, 4)
    else:
        plan = plan_from_replicas(pop, np.full((E,), reps, np.int64), n_dev,
                                  max_pack=4)
    rw = route_weights(plan)
    if dead:
        rw = serving.mask_dead_route_weights(rw, plan.replica_of,
                                             plan.max_pack, dead)
    return {f"{name}/slot_expert": plan.slot_expert.astype(np.int32),
            f"{name}/replica_of": plan.replica_of.astype(np.int32),
            f"{name}/n_replicas": plan.n_replicas.astype(np.int32),
            f"{name}/route_weight": np.asarray(rw, np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ep")
    rng = np.random.RandomState(0)

    def w(*shape):
        return (rng.randn(*shape) * shape[-2] ** -0.5).astype(np.float32)
    inp = {"x": rng.randn(64, D).astype(np.float32), "router": w(D, E),
           "wi": w(E, D, F), "wu": w(E, D, F), "wo": w(E, F, D)}
    for name in SERVE_CASES:
        inp.update(_plan_tables(name, rng))
    for i, (n_dev, reps) in enumerate(((4, None), (4, 2), (4, 3))):
        pop = rng.dirichlet(np.full(E, 0.5))
        plan = plan_placement(pop, n_dev, 4) if reps is None else \
            plan_from_replicas(pop, np.full((E,), reps, np.int64), n_dev,
                               max_pack=4, rep_width=reps)
        for f, a in (("slot_expert", plan.slot_expert),
                     ("replica_of", plan.replica_of),
                     ("n_replicas", plan.n_replicas),
                     ("route_weight", route_weights(plan))):
            inp[f"stack{i}/{f}"] = np.asarray(a)
    vocab = 512
    inp["serve_tokens"] = rng.randint(0, vocab, (2, 10))
    inp["tokens"] = rng.randint(0, vocab, (4, 12))
    inp["lengths"] = np.array([12, 9, 5, 0])
    inp["path_init"] = rng.randint(0, 64, (4, 12))
    inp["next"] = rng.randint(0, vocab, (4,))
    inp["trace_tokens"] = rng.randint(0, vocab, (6, 8))
    inp["trace_at"] = np.cumsum(rng.exponential(0.01, 6))
    np.savez(tmp / "inp.npz", **inp)
    import json
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF),
                        str(tmp / "inp.npz"), str(tmp / "ref.npz"),
                        json.dumps(SERVE_CASES), str(tmp / "params.npz"),
                        str(SERVE_CF)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    layer = run_ranks(serve_layer_body, 8, tmp, str(tmp / "inp.npz"), (2, 4))
    server = run_ranks(serve_server_body, 4, tmp, str(tmp / "params.npz"),
                       str(tmp / "inp.npz"))
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "inp.npz")), \
        layer, server


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_serve_layer_matches_reference_on_a_2x4_mesh(runs, name):
    want, _, got, _ = runs
    for r, g in enumerate(got):
        g = g[name]
        np.testing.assert_array_equal(g["eidx"], want[name + "/eidx"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(g["y"], want[name + "/y"], atol=Y_ATOL,
                                   rtol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(g["probs"], want[name + "/probs"],
                                   atol=PROB_ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        assert g["prefetched_bitwise"] and g["fetched_exact"], r


def test_dp_shard_count_and_stack_plan_arrays_match_reference(runs):
    want, inp, got, _ = runs
    assert [serving.dp_shard_count(None, 64)] == \
        list(want["dp_shard_count"][3:])
    for g in got:
        assert g["dp_shard_count"] == list(want["dp_shard_count"][:3])
    plans = [serving.PlanArrays(*(torch.from_numpy(inp[f"stack{i}/{f}"])
                                  for f in serving.PlanArrays._fields))
             for i in range(3)]
    st = serving.stack_plan_arrays(plans, device="cpu")
    assert st.stacked and not plans[0].stacked
    for f, a in zip(serving.PlanArrays._fields, st):
        np.testing.assert_array_equal(a.numpy(), want["stacked/" + f],
                                      err_msg=f)
    one = st.layer(1)
    np.testing.assert_array_equal(one.slot_expert.numpy(),
                                  inp["stack1/slot_expert"])


@pytest.mark.parametrize("route_mode", ["weighted", "round_robin"])
def test_replica_token_counts_with_dp_shards_match_reference(route_mode):
    rng = np.random.RandomState(3)
    pop = rng.dirichlet(np.full(E, 0.5))
    plan = plan_placement(pop, 8, 4)
    hplan = serving.PlanArrays(plan.slot_expert, plan.replica_of,
                               plan.n_replicas, route_weights(plan))
    jplan = jserving.PlanArrays(*hplan)
    idx = rng.randint(0, E, (48, 2)).astype(np.int32)
    valid = np.arange(48) < 40
    for shards in (1, 2):
        got = serving.replica_token_counts(idx, hplan, 16, 8, valid=valid,
                                           dp_shards=shards,
                                           route_mode=route_mode)
        np.testing.assert_array_equal(got, jserving.replica_token_counts(
            idx, jplan, 16, 8, valid=valid, dp_shards=shards,
            route_mode=route_mode))
    # two shards route apart: their sum is not the unsharded count
    assert not np.array_equal(
        serving.replica_token_counts(idx, hplan, 8, 8, dp_shards=1,
                                     route_mode=route_mode),
        serving.replica_token_counts(idx, hplan, 8, 8, dp_shards=2,
                                     route_mode=route_mode))


def _held(want, tag, logits, path, stats):
    np.testing.assert_allclose(logits, want[tag + "/logits"], atol=Y_ATOL,
                               rtol=0, err_msg=tag)
    np.testing.assert_array_equal(path, want[tag + "/path"], err_msg=tag)
    for i, s in enumerate(stats):
        key = f"{tag}/stats{i}"
        np.testing.assert_array_equal(s["replica_load"],
                                      want[key + "/replica_load"])
        assert [s["layer"], s["finetuned"], s["est_accurate"],
                s["plan_reused"], s["n_tokens"]] == \
            list(want[key + "/flags"]), key
        for f in ("est_pop", "actual_pop", "device_load"):
            np.testing.assert_allclose(s[f], want[f"{key}/{f}"], atol=1e-6,
                                       rtol=0, err_msg=f"{key} {f}")


@pytest.mark.parametrize("phase", ["serve", "prefill", "decode"])
def test_server_matches_reference_on_a_2x2_mesh(runs, phase):
    want, _, _, got = runs
    for g in got:
        np.testing.assert_array_equal(g["counts"], want["srv/counts"])
        if phase == "decode":
            for i, (logits, path, stats) in enumerate(g["decode"]):
                _held(want, f"srv/decode{i}", logits, path, stats)
        else:
            _held(want, f"srv/{phase}", *g[phase])


def test_simulate_with_a_slow_rank_agrees_on_every_rank(runs):
    _, inp, _, got = runs
    first = got[0]["simulate"]
    assert [r[0] for r in first] == list(range(len(inp["trace_at"])))
    for g in got[1:]:
        assert g["simulate"] == first
    for rid, tokens, arrival, completion, ttft in first:
        assert len(tokens) == 2
        # every step waited on the slowed rank: 4 MoE layers a forward
        assert completion - arrival >= 4 * SLOW_S


def test_server_keeps_one_hosted_stack_a_layer(runs):
    """At ep 2 the server keeps the hosted experts of each MoE layer's
    current plan only, however many plans the run installed."""
    from repro_torch.configs import get_config
    n_moe = get_config("gpt2-moe-smoke").n_moe_layers
    for g in runs[3]:
        layers, n_plans = g["hosted"]
        assert layers == list(range(n_moe))
        assert n_plans >= n_moe
