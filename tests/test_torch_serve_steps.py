"""The transformer branch of the port's serve entry points
(``models.lm.forward_prefill`` / ``init_cache`` / ``decode_step`` through
``launch.steps.make_prefill_step`` / ``make_decode_step`` /
``make_serve_plan``) against the reference's steps on the CPU, on
``gpt2-moe-smoke`` with the reference's weights.

Each mesh shape, None, (1, 4) and (2, 4), runs three plans: none (each MoE
layer is ``moe_layer`` on the reference's token shard), the identity plan
of ``make_serve_plan`` and a stacked plan (a placement plan a layer, each
rotated so that the logits show which plan a layer ran under:
``_stacked_tables``); the port's params are this rank's ``fsdp`` shard,
as the reference's steps default to.  The reference's prefill takes one
plan for every layer, so its stacked prefill is its own layer groups
(``lm._group_apply``) run each under its layer's plan.  Held: the prefill
logits, two decode steps' logits (within 1e-5), their expert choices
(exact) and the cache after them (within 1e-5).  The reference runs in one
subprocess with 8 forced host devices and a float32 cache (its bf16 cache
does not take the float32 model's keys); the port's ranks are spawned
once per mesh.

Also: ``init_cache``'s shapes against the reference's, and decoding a
prompt a token at a time ending at prefill's last-position logits (no
token dropped), with no mesh and on the (2, 4) mesh.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import (STEP_PLANS, decode_matches_prefill,
                          params_from_npz, run_ranks, serve_steps,
                          serve_steps_body)
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core.placement import plan_placement, route_weights
from repro_torch.models import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
MESHES = {"none": None, "1x4": (1, 4), "2x4": (2, 4)}

REF = """
import contextlib, sys, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.serving import PlanArrays
from repro.launch import steps
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import lm
from repro.models.layers import rms_norm
from repro_torch.convert import from_reference
from repro_torch.tree import tree_items
inp = dict(np.load(sys.argv[1]))
cfg = get_config("gpt2-moe-smoke")
params = lm.init_params(cfg, jax.random.PRNGKey(2))
np.savez(sys.argv[3], **{p: a.numpy() for p, a in tree_items(
    from_reference(jax.tree.map(np.asarray, params), device="cpu"))})
tokens = jnp.asarray(inp["tokens"], jnp.int32)
out = {}


def stacked_prefill(mesh, params, batch, plan):
    p = lm.cast_for_compute(cfg, params)
    x = lm.embed_inputs(cfg, p, tokens=batch["tokens"])
    for g in range(cfg.n_layers // cfg.moe.every):
        gp = jax.tree.map(lambda a: a[g], p.stack)
        pl = PlanArrays(*(a[g] for a in plan))
        x, _, _, _ = lm._group_apply(mesh, cfg, gp, x, lina=False,
                                     serve_plan=pl, fsdp=True)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    return x[:, -1] @ lm.unembed_weight(p)


for tag, shape in json.loads(sys.argv[4]).items():
    mesh = None if shape is None else make_mesh(shape, ("data", "model"))
    single = steps.make_serve_plan(cfg, mesh)
    for f, a in zip(PlanArrays._fields, single):
        out[f"{tag}/single/{f}"] = np.asarray(a)
    stacked = PlanArrays(*(jnp.asarray(inp[f"{tag}/stacked/{f}"])
                           for f in PlanArrays._fields))
    for name, plan in (("none", None), ("single", single),
                       ("stacked", stacked)):
        if name == "stacked":
            pre = lambda p, b: stacked_prefill(mesh, p, b, stacked)
        else:
            pre = steps.make_prefill_step(cfg, mesh, serve_plan=plan)
        dec = steps.make_decode_step(cfg, mesh, serve_plan=plan)
        cache = lm.init_cache(cfg, tokens.shape[0], 12, dtype=jnp.float32)
        with mesh_context(mesh) if mesh is not None else \
                contextlib.nullcontext():
            out[f"{tag}/{name}/prefill"] = np.asarray(
                jax.jit(pre)(params, {"tokens": tokens}))
            jdec = jax.jit(dec)
            for i in range(2):
                logits, cache, experts = jdec(params, cache, tokens[:, i])
                out[f"{tag}/{name}/decode{i}/logits"] = np.asarray(logits)
                out[f"{tag}/{name}/decode{i}/experts"] = np.asarray(experts)
            out[f"{tag}/{name}/cache_k"] = np.asarray(cache.kv.k)
np.savez(sys.argv[2], **out)
"""


def _stacked_tables(cfg, ep, rng) -> dict:
    """A placement plan a MoE layer over ``ep`` devices, with the identity
    plan's sub-slot count (so the stack is rectangular).  Layer l's slots
    host expert (e + l) mod E where its tables route expert e: a plan
    whose tables agree changes no number when nothing is dropped, and
    these show in the logits which plan each layer ran under."""
    e = cfg.moe.n_experts
    pack = max(max(1, e // ep), 2)
    plans = [plan_placement(rng.dirichlet(np.full(e, 0.5)), ep, pack)
             for _ in range(cfg.n_moe_layers)]
    r = max(p.replica_of.shape[1] for p in plans)

    def pad(a, fill):
        return np.pad(a, ((0, 0), (0, r - a.shape[1])), constant_values=fill)
    return {"slot_expert": np.stack([
                np.where(p.slot_expert >= 0, (p.slot_expert + l) % e, -1)
                for l, p in enumerate(plans)]),
            "replica_of": np.stack([pad(p.replica_of, -1) for p in plans]),
            "n_replicas": np.stack([p.n_replicas for p in plans]),
            "route_weight": np.stack([pad(route_weights(p), 0.0)
                                      for p in plans]).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_steps")
    cfg = get_config("gpt2-moe-smoke")
    rng = np.random.RandomState(0)
    inp = {"tokens": rng.randint(0, cfg.vocab_size, (4, 8))}
    for tag, shape in MESHES.items():
        ep = 1 if shape is None else shape[1]
        for f, a in _stacked_tables(cfg, ep, rng).items():
            inp[f"{tag}/stacked/{f}"] = a
    np.savez(tmp / "inp.npz", **inp)
    import json
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF),
                        str(tmp / "inp.npz"), str(tmp / "ref.npz"),
                        str(tmp / "params.npz"), json.dumps(MESHES)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    params = params_from_npz(cfg, tmp / "params.npz")
    inp = dict(np.load(tmp / "inp.npz"))
    got = {"none": serve_steps(cfg, params, None, inp)}
    for tag in ("1x4", "2x4"):
        got[tag] = run_ranks(serve_steps_body, 4 if tag == "1x4" else 8,
                             tmp, str(tmp / "params.npz"),
                             str(tmp / "inp.npz"), MESHES[tag])
    return dict(np.load(tmp / "ref.npz")), got, params, inp


def _rank_results(got, tag):
    return [got[tag]] if tag == "none" else got[tag]


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("plan", STEP_PLANS)
def test_prefill_step_matches_reference(runs, tag, plan):
    want, got, _, _ = runs
    for r, g in enumerate(_rank_results(got, tag)):
        np.testing.assert_allclose(g[plan]["prefill"],
                                   want[f"{tag}/{plan}/prefill"], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("plan", STEP_PLANS)
def test_decode_step_matches_reference(runs, tag, plan):
    want, got, _, _ = runs
    for r, g in enumerate(_rank_results(got, tag)):
        for i, (logits, experts) in enumerate(g[plan]["decode"]):
            key = f"{tag}/{plan}/decode{i}"
            np.testing.assert_allclose(logits, want[key + "/logits"],
                                       atol=ATOL, rtol=0,
                                       err_msg=f"rank {r} step {i}")
            np.testing.assert_array_equal(experts, want[key + "/experts"],
                                          err_msg=f"rank {r} step {i}")
        np.testing.assert_allclose(g[plan]["cache_k"],
                                   want[f"{tag}/{plan}/cache_k"], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("tag", list(MESHES))
def test_make_serve_plan_matches_reference(runs, tag):
    want, got, _, _ = runs
    from repro_torch.core.serving import PlanArrays
    for g in _rank_results(got, tag):
        for f, a in zip(PlanArrays._fields, g["plan"]):
            np.testing.assert_allclose(a, want[f"{tag}/single/{f}"],
                                       atol=1e-7, rtol=0, err_msg=f)


@pytest.mark.parametrize("arch", ["gpt2-moe-smoke", "mixtral-8x22b-smoke"])
def test_init_cache_shapes_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    seq = 40                      # past mixtral-smoke's window of 16
    got = lm.init_cache(cfg, 3, seq, device="cpu")
    want = jlm.init_cache(jcfg, 3, seq)
    assert got.kv.k.shape == got.kv.v.shape == want.kv.k.shape
    assert got.kv.k.dtype == torch.bfloat16
    assert got.mamba is None and got.rwkv is None
    assert tuple(got.pos.shape) == want.pos.shape


def test_decode_matches_prefill_at_the_prompt_end(runs):
    _, got, params, inp = runs
    cfg = get_config("gpt2-moe-smoke")
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    errs = decode_matches_prefill(roomy, params, None,
                                  torch.from_numpy(inp["tokens"]))
    for g in got["2x4"]:
        errs += g["decode_vs_prefill"]
    assert max(errs) < 1e-5, errs
