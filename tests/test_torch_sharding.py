"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), and the meshes they run on.

For every registry config, on its ``arch_mesh`` at 16 x 16 and with
``multi_pod`` (2 x 16 x 16), ``param_specs``, ``serve_param_specs``,
``opt_state_specs``, ``batch_specs`` (each shape), ``cache_specs`` (each
decode shape) and ``serve_uses_fsdp`` equal the reference's, leaf for
leaf, after ``safe_spec``.  The reference's functions take a stand-in mesh
(``axis_names`` and ``devices.shape``) and the params' shapes from
``jax.eval_shape``; the port's take a ``RecordingMesh`` of the same names
and sizes, and its ``arch_mesh`` (`pod` folded into `data`) gives the same
trees with (`pod`, `data`) read as `data`.  Shards: every rank's block of a
leaf by its spec tiles the leaf exactly once.  ``MirrorMesh``: rank 0's
dense-sharded train step and prefill on one process equal a 4-rank gloo
run in which every rank holds rank 0's shards and batch and takes rank
0's coordinates (within 1e-6: a gloo sum of four equal values against four
times the value), qwen3-8b on (2, 2) and mixtral-8x22b with expert
slicing on (2, 1, 2): a real all-to-all hands each rank the blocks sent
to it, which differ from rank 0's, so a real world of equal ranks has
one `model` rank; the mirror's all-to-all is held to its definition
alone.  A mirror's program at full width keeps its ids in rank 0's vocab
block and its gradients finite.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_threads import share_cores
from _torch_ranks import mirror_body, run_ranks
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import sharding as jsh
from repro.models import lm as jlm
from repro.models.layers import safe_spec as j_safe_spec
from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.core import axes
from repro_torch.core.axes import Spec
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import RecordingMesh, arch_mesh
from repro_torch.models import lm
from repro_torch.tree import tree_items

share_cores()

NAMES = list(REGISTRY)       # the assigned ten and the paper's four
DECODES = [s for s in SHAPES.values() if s.kind in ("decode", "long_decode")]


def ref_shape(cfg, multi_pod: bool) -> tuple:
    """The reference's ``arch_mesh`` (shape, names) for ``cfg``."""
    e = cfg.moe.n_experts if cfg.moe.enabled else 0
    if not e or 16 % e or e >= 16:
        shape, names = (16, 16), ("data", "model")
    else:
        shape, names = (16, e, 16 // e), ("data", "model", "tp")
    if multi_pod:
        shape, names = (2,) + shape, ("pod",) + names
    return shape, names


def stand_in(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def as_spec(p) -> Spec:
    return Spec(*tuple(p))


def walk(ref_vals, ref_specs, port_specs, path=""):
    """[(path, reference spec, port spec)] for every leaf the reference
    has (a spec where the value is None is skipped)."""
    if ref_vals is None:
        return []
    if hasattr(ref_vals, "_fields"):
        out = []
        for f in ref_vals._fields:
            out += walk(getattr(ref_vals, f), getattr(ref_specs, f),
                        getattr(port_specs, f), f"{path}/{f}")
        return out
    return [(path, ref_specs, port_specs)]


def ref_safe(mesh, spec_tree, vals):
    def one(spec, v):
        if v is None:
            return None
        return j_safe_spec(mesh, spec if spec is not None else P(), v.shape)
    return jax.tree.map(one, spec_tree, vals,
                        is_leaf=lambda s: isinstance(s, P) or s is None)


def fold(spec: Spec) -> Spec:
    """A spec over (pod, data, ...) as the port's folded mesh names it."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = tuple(a for a in e if a != axes.POD)
        out.append(e)
    return Spec(*out)


@pytest.fixture(scope="module", params=NAMES)
def shapes(request):
    jcfg = j_get_config(request.param)
    jp = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    cfg = get_config(request.param)
    return jcfg, jp, cfg, lm.init_params(cfg, None, device="meta")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_equal_the_references(shapes, multi_pod):
    jcfg, jp, cfg, params = shapes
    shape, names = ref_shape(cfg, multi_pod)
    jm, pm = stand_in(shape, names), RecordingMesh(shape, names)
    am = arch_mesh(cfg, multi_pod)
    assert am.shape == ((shape[0] * shape[1],) + shape[2:] if multi_pod
                        else shape)
    for serve in (False, True):
        jrule = jsh.serve_param_specs if serve else jsh.param_specs
        rule = sh.serve_param_specs if serve else sh.param_specs
        want = ref_safe(jm, jrule(jcfg, jm, jp), jp)
        got = sh.safe_specs(pm, rule(cfg, pm, params), params)
        folded = sh.safe_specs(am, rule(cfg, am, params), params)
        leaves = walk(jp, want, got)
        assert len(leaves) == len(tree_items(params))
        fl = dict(tree_items(folded))
        for path, w, g in leaves:
            assert g == as_spec(w), (serve, path, w, g)
            assert fl[path[1:]] == fold(g), (serve, path)
        if not serve:
            opt = sh.opt_state_specs(got)
            assert opt.step == Spec() and opt.m is got and opt.v is got
    assert sh.serve_uses_fsdp(cfg, pm) == jsh.serve_uses_fsdp(jcfg, jm) \
        == sh.serve_uses_fsdp(cfg, am)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_cache_specs_equal_the_references(shapes, multi_pod):
    jcfg, _, cfg, _ = shapes
    shape, names = ref_shape(cfg, multi_pod)
    jm, pm = stand_in(shape, names), RecordingMesh(shape, names)
    for name, s in SHAPES.items():
        want = jsh.batch_specs(jcfg, jm, J_SHAPES[name])
        got = sh.batch_specs(cfg, pm, s)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == as_spec(want[k]), (name, k)
    if not cfg.causal:
        return
    for s in DECODES:
        jc = jax.eval_shape(lambda: jlm.init_cache(
            jcfg, s.global_batch, s.seq_len, jnp.bfloat16))
        cache = lm.init_cache(cfg, s.global_batch, s.seq_len,
                              device="meta")
        want = ref_safe(jm, jsh.cache_specs(jcfg, jm, jc), jc)
        got = sh.safe_specs(pm, sh.cache_specs(cfg, pm, cache), cache)
        leaves = walk(jc, want, got)
        assert len(leaves) == len(tree_items(cache))
        for path, w, g in leaves:
            assert g == as_spec(w), (s.name, path)


def test_a_tensor_parallel_free_config_is_all_fsdp():
    """``tensor_parallel=False`` (no registry config sets it): every axis
    is a data axis, in both packages."""
    jcfg = dataclasses.replace(j_get_config("qwen3-8b"),
                               tensor_parallel=False)
    cfg = dataclasses.replace(get_config("qwen3-8b"), tensor_parallel=False)
    jp = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    params = lm.init_params(cfg, None, device="meta")
    jm, pm = stand_in((16, 16), ("data", "model")), RecordingMesh((16, 16))
    want = ref_safe(jm, jsh.param_specs(jcfg, jm, jp), jp)
    got = sh.safe_specs(pm, sh.param_specs(cfg, pm, params), params)
    for path, w, g in walk(jp, want, got):
        assert g == as_spec(w), path
    assert got.stack.attn.wq == Spec(None, None, ("data", "model"))


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-8b-smoke", (2, 2)), ("mixtral-8x22b-smoke", (1, 2, 2)),
    ("zamba2-1.2b-smoke", (2, 2)), ("rwkv6-1.6b-smoke", (2, 2))])
def test_every_ranks_blocks_tile_each_leaf_once(arch, shape):
    """``convert.shard_leaf`` at every rank of ``shape``: the blocks of a
    leaf of distinct values cover each element once per replica."""
    cfg = get_config(arch)
    names = ("data", "model", "tp")[:len(shape)]
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, device="cpu")
    specs = sh.safe_specs(RecordingMesh(shape, names),
                          sh.param_specs(cfg, RecordingMesh(shape, names),
                                         params), params)
    world = int(np.prod(shape))
    from repro_torch.convert import shard_leaf
    for (path, w), (_, s) in zip(tree_items(params), tree_items(specs)):
        ids = torch.arange(w.numel(), dtype=torch.float64).reshape(w.shape)
        seen = torch.zeros(w.numel(), dtype=torch.int64)
        reps = world // int(np.prod([sh.axis_size(
            RecordingMesh(shape, names), s.axes_of(i))
            for i in range(w.dim())] or [1]))
        for r in range(world):
            blk = shard_leaf(ids, RecordingMesh(shape, names, rank=r), s)
            seen.index_add_(0, blk.reshape(-1).long(),
                            torch.ones(blk.numel(), dtype=torch.int64))
        assert bool((seen == reps).all()), path


@pytest.fixture(scope="module")
def mirrored(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mirror")
    real = run_ranks(mirror_body, 4, tmp, False)[0]
    return real, mirror_body(0, True)


@pytest.mark.parametrize("case", ["qwen3-8b-smoke", "mixtral-8x22b-smoke"])
def test_mirror_mesh_equals_a_world_of_equal_ranks(mirrored, case):
    real, one = mirrored
    assert real[case].keys() == one[case].keys()
    for k in real[case]:
        np.testing.assert_allclose(one[case][k], real[case][k], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{case} {k}")
    assert one[case + "/records"] == real[case + "/records"]


def test_mirror_all_to_all_hands_back_this_ranks_block():
    from repro_torch.launch.mesh import MirrorMesh
    m = MirrorMesh((1, 4), device="cpu", rank=2)
    x = torch.arange(8.0).reshape(4, 2)
    out = torch.empty_like(x)
    m.all_to_all(out, x, m.group(axes.MODEL))
    assert out.tolist() == [[4.0, 5.0]] * 4
    assert m.records[0].kind == "all-to-all"


def test_a_mirror_program_keeps_its_ids_in_rank0s_vocab_block():
    """Rank 0's program on a ``MirrorMesh`` (``dryrun.step_program``):
    qwen3-8b at full width, 2 layers, on its 16 x 16 ``arch_mesh``.  Its
    token ids and labels lie in rank 0's block of the vocab-sharded
    embedding (a token outside it has no row in a world of equal ranks),
    and one step's loss and every gradient are finite."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MirrorMesh
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    rec = arch_mesh(cfg)
    mm = MirrorMesh(rec.shape, rec.axis_names, device="cpu")
    step, (params, opt, batch) = dryrun.step_program(
        cfg, "train", 1, 64, mesh=mm, device="cpu", global_batch=16)
    v_loc = params.embed.shape[0]
    assert v_loc == cfg.vocab_size // 16
    for k in ("tokens", "labels"):
        assert int(batch[k].max()) < v_loc and int(batch[k].min()) >= 0
    grads, loss, _, _ = step.reduced_grads(params, batch)
    assert bool(torch.isfinite(loss))
    for path, g in tree_items(grads):
        assert bool(torch.isfinite(g).all()), path
