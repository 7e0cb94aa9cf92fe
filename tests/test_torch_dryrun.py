"""The meta route and the dry run (``launch/dryrun.py``): every kernel
wrapper on ``meta`` (its contract, then its outputs allocated there)
against its CPU route, the peak tracker against a hand count, one dry-run
cell against the reference's result keys, the cells it skips, and the
collectives a (2, 2) recording mesh records against what the same steps
issue on 4 gloo ranks.

The reference's variants (``src/repro/launch/dryrun.py:52-135, 225-241``):
each runs ``ok`` on a production cell cut to two layers and its result
carries the values it ran with; the ``kv_split`` and ``cache_batch_only``
decode caches' spec trees equal the reference's (its ``cache_specs`` with
the KV leaves its dry run writes, after ``safe_spec``) for every config
with a KV cache, on 16 x 16 and 2 x 16 x 16; with sequence parallelism off
qwen3-8b train_4k keeps its peak of 32,138,467,344 bytes; with it on (the
default) qwen2-72b train_4k at four layers drops by more than the four
group boundaries' saved carries, 15 / 16 of [16, 4096, 8192] bf16 each;
``kv_split``, which re-views the production mesh, refuses an explicit
one.  Lina's pipelined expert-parallel backward exchanges the same
micro-ops as the backward that waited for every chunk of dy first: the
all-to-all records of gpt2-moe and mixtral-8x22b train_4k on their
default meshes (count, raw and wire bytes of rank 0) are frozen at that
backward's."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_threads import share_cores
from _torch_ranks import record_config, record_steps_body, run_ranks
from test_torch_sharding import as_spec, ref_safe, ref_shape, stand_in, walk
from repro.configs import get_config as j_get_config
from repro.core import axes as jax_axes
from repro.launch import sharding as jsh
from repro.models import lm as jlm
from repro.models.attention import KVCache as JKVCache
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import kv_split_mesh
from repro_torch.models import lm
from repro_torch.tree import tree_items
from repro_torch.analysis.kernels import (REGISTRY, contract_of,
                                          edge_contract_args, wrapper_of)
from repro_torch.devices import resolve_device
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels._build import KernelRefused
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RecordingMesh, make_production_mesh

share_cores()

# the reference's result keys (src/repro/launch/dryrun.py) whose meaning
# the port keeps
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "status", "lina",
            "analytic_flops_global", "analytic_hbm_bytes_global",
            "collectives", "memory_analysis", "roofline",
            "model_flops_global", "useful_flops_ratio", "dominant_term",
            "roofline_fraction"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
              "peak_bytes_estimate"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s",
                "collective_s_single_link"}
REF_COLLECTIVES = {"entry", "wire_bytes", "raw_bytes", "counts",
                   "total_wire_bytes", "total_raw_bytes"}


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)] \
        if isinstance(out, (tuple, list)) else []


def _edges(accepted: bool):
    return [pytest.param(name, ec, id=f"{name}:{ec.name}")
            for name, e in REGISTRY.items() for ec in e.edges
            if ec.accepted == accepted]


def test_meta_is_the_third_place_to_run():
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        resolve_device("xpu")


@pytest.mark.parametrize("name,ec", _edges(True))
def test_meta_route_outputs_are_the_cpu_routes(name, ec):
    """Shapes and dtypes of every output as the plain version gives them;
    no launch counted."""
    entry = REGISTRY[name]
    fn = wrapper_of(entry)
    gen = torch.Generator().manual_seed(0)
    args, kwargs = ec.build("cpu", gen)
    cpu = _leaves(fn(*args, **kwargs))
    reset_counters()
    args, kwargs = ec.build("meta", None)
    meta = _leaves(fn(*args, **kwargs))
    assert [(tuple(t.shape), t.dtype) for t in meta] == \
        [(tuple(t.shape), t.dtype) for t in cpu]
    assert all(t.is_meta for t in meta)
    assert all(c.count == 0 for c in COUNTERS.values())


@pytest.mark.parametrize("name,ec", _edges(False))
def test_meta_route_refuses_as_the_contract_does(name, ec):
    """The wrapper on ``meta`` raises what the kernel route's contract
    raises for the same tensors on another device."""
    entry = REGISTRY[name]
    gen = torch.Generator().manual_seed(0)
    cargs, ckw = edge_contract_args(entry, *ec.build("cpu", gen))
    with pytest.raises(KernelRefused) as real:
        contract_of(entry)(*cargs, **ckw)
    reset_counters()
    with pytest.raises(type(real.value)) as meta:
        args, kwargs = ec.build("meta", None)
        wrapper_of(entry)(*args, **kwargs)
    assert str(meta.value) == str(real.value)
    assert all(c.count == 0 for c in COUNTERS.values())


def test_peak_tracker_by_hand():
    """1 MiB and 3 MiB live (4), the first freed (3), then 2 MiB (5), the
    3 MiB kept by a view: the peak is 5 MiB, and a storage leaves the sum
    only when freed; an argument and its views are not counted."""
    arg = torch.empty(1 << 20, dtype=torch.uint8, device="meta")
    with dryrun.PeakTracker() as pt:
        a = torch.empty(1 << 20, dtype=torch.uint8, device="meta")
        b = torch.empty(3 << 20, dtype=torch.uint8, device="meta")
        v = arg[10:]
        w = b.view(3, -1)
        assert pt.current == 4 << 20
        del a
        assert pt.current == 3 << 20
        c = torch.empty(1 << 19, dtype=torch.float32, device="meta")
        assert pt.current == 5 << 20
        del b
        assert pt.current == 5 << 20          # w keeps b's storage
        del w, c
    assert pt.peak == 5 << 20 and pt.current == 0 and pt.allocs == 3
    assert v.untyped_storage()._cdata == arg.untyped_storage()._cdata


def test_one_cell_keeps_the_references_keys(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: record_config())
    res = dryrun.run_cell("gpt2-moe-smoke", "train_4k", mesh_shape=(2, 2),
                          batch=8, seq=32, verbose=False)
    assert res["status"] == "ok" and REF_KEYS <= set(res)
    assert REF_MEMORY <= set(res["memory_analysis"])
    assert REF_ROOFLINE == set(res["roofline"])
    assert REF_COLLECTIVES <= set(res["collectives"])
    assert res["n_chips"] == 4 and res["mesh"] == "2x2"
    mem = res["memory_analysis"]
    assert mem["peak_bytes_estimate"] == mem["argument_bytes"] + \
        mem["temp_bytes"] > 0
    assert res["fits"] is True
    assert res["collectives"]["counts"]["all-to-all"] > 0
    assert res["dominant_term"] in ("compute_s", "memory_s", "collective_s")


def test_cells_the_port_cannot_run_are_skips_with_their_reason():
    """Only the reference's skips and a kernel's refusal skip a cell:
    mixtral-8x22b runs on its ``arch_mesh`` (16, 8, 2) (expert slicing),
    a multi-pod training batch splits over its 32 data ranks."""
    mix = dryrun.run_cell("mixtral-8x22b", "train_4k", verbose=False)
    assert mix["status"] == "ok" and mix["mesh_shape"] == [16, 8, 2]
    assert mix["rank0_batch"] == 16 and mix["fits"] is True
    enc = dryrun.run_cell("hubert-xlarge", "decode_32k", verbose=False)
    assert enc["status"] == "skip" and "encoder-only" in enc["reason"]
    pod = dryrun.run_cell("qwen3-8b", "train_4k", multi_pod=True,
                          verbose=False)
    assert pod["status"] == "ok" and pod["rank0_batch"] == 8
    assert pod["fits"] is True
    smoke = dryrun.run_cell("gpt2-moe-smoke", "prefill_32k",
                            mesh_shape=(2, 2), batch=2, seq=64,
                            verbose=False)
    assert smoke["status"] == "skip" and smoke["reason"].startswith(
        "refused")


def test_a_fault_that_is_no_refusal_is_an_error(monkeypatch):
    """Only a kernel contract's ``KernelRefused`` makes a cell a skip;
    any other exception on the step's path is an error."""
    def fault(step, args):
        raise ValueError("a fault of the port")
    monkeypatch.setattr(dryrun, "meta_peak", fault)
    res = dryrun.run_cell("gpt2-moe-smoke", "train_4k", mesh_shape=(2, 2),
                          batch=8, seq=32, layers=2, verbose=False)
    assert res["status"] == "error" and "a fault of the port" in res["error"]

    def refusal(step, args):
        raise KernelRefused("the kernel takes no such shape")
    monkeypatch.setattr(dryrun, "meta_peak", refusal)
    res = dryrun.run_cell("gpt2-moe-smoke", "train_4k", mesh_shape=(2, 2),
                          batch=8, seq=32, layers=2, verbose=False)
    assert res == {"arch": "gpt2-moe-smoke", "shape": "train_4k",
                   "mesh": "2x2", "status": "skip",
                   "reason": "refused: the kernel takes no such shape"}


def test_production_meshes():
    m = make_production_mesh()
    assert (m.shape, m.world, m.size("data"), m.size("model")) == \
        ((16, 16), 256, 16, 16)
    p = make_production_mesh(multi_pod=True)
    assert (p.shape, p.group_size(p.dp_group)) == ((32, 16), 32)
    assert m.coords == {"data": 0, "model": 0} and m.device.type == "meta"


def test_recorded_collectives_are_the_gloo_ranks(tmp_path):
    """gpt2-moe-smoke's train step and serve prefill on a (2, 2) recording
    mesh record, record for record, what the same programs issue on 4
    gloo ranks through the same ``Mesh`` methods."""
    shape, train_b, serve_b, seq = (2, 2), 2, 4, 32
    ranks = run_ranks(record_steps_body, 4, tmp_path, shape, train_b,
                      serve_b, seq)
    rec = {}
    for kind, b in (("train", train_b), ("prefill", serve_b)):
        mesh = RecordingMesh(shape)
        step, args = dryrun.step_program(record_config(), kind, b, seq,
                                         mesh=mesh)
        mesh.records = []
        step(*args)
        rec[kind] = [tuple(r) for r in mesh.records]
    for kind in ("train", "prefill"):
        assert rec[kind], kind
        assert {r[0] for r in rec[kind]} >= {"all-to-all"}
        for r, got in enumerate(ranks):
            assert got[kind] == rec[kind], (kind, r)


# (variant, arch, shape, run_cell keywords): each on its production mesh
# at two layers
VARIANTS = (
    ("no_sp", "qwen3-8b", "train_4k", dict(seq_parallel=False)),
    ("no_lina", "gpt2-moe", "train_4k", dict(lina=False)),
    ("microbatches", "gpt2-moe", "train_4k", dict(microbatches=2)),
    ("dp_only", "mixtral-8x22b", "train_4k", dict(dp_only=True)),
    ("kv_split", "qwen3-8b", "decode_32k", dict(kv_split=True)),
    ("cache_batch_only", "qwen2-72b", "decode_32k",
     dict(cache_batch_only=True)),
    ("tag", "qwen3-8b", "prefill_32k", dict(tag="hill-climb 1")),
)


@pytest.mark.parametrize("name,arch,shape,kw", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_each_variant_runs_ok_on_a_production_cell(name, arch, shape, kw):
    res = dryrun.run_cell(arch, shape, layers=2, verbose=False, **kw)
    assert res["status"] == "ok", res.get("error") or res.get("reason")
    want = {"lina": True, "seq_parallel": True, "microbatches": 1,
            "dp_only": False, "kv_split": False, "cache_batch_only": False,
            "tag": "", **kw}
    assert {k: res[k] for k in want} == want
    if name == "kv_split":      # `model` re-viewed as (8 kv heads, tp 2)
        assert res["mesh_shape"] == [16, 8, 2]


def test_kv_split_skips_where_the_kv_heads_do_not_divide_16():
    res = dryrun.run_cell("gpt2-moe", "decode_32k", kv_split=True,
                          verbose=False)
    assert res["status"] == "skip" and "12 kv heads" in res["reason"]


def test_kv_split_refuses_an_explicit_mesh(capsys):
    with pytest.raises(ValueError, match="kv_split"):
        dryrun.run_cell("qwen3-8b", "decode_32k", kv_split=True,
                        mesh_shape=(2, 2), layers=2, verbose=False)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                     "--kv-split", "--mesh", "2x2"])
    assert "--kv-split" in capsys.readouterr().err


def _kv_literal(lead, dpx, seq, heads):
    """The KV leaves the reference's dry run writes (its lines 96-117)."""
    return JKVCache(*(P(*(None,) * lead, dpx, seq, heads, None)
                      for _ in range(2)))


KV_ARCHS = [c.name for c in ASSIGNED if c.causal and not c.attention_free]
DECODES = [s for s in SHAPES.values() if s.kind in ("decode", "long_decode")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", KV_ARCHS)
def test_kv_split_and_batch_only_cache_specs_equal_the_references(
        arch, multi_pod):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    dpx = jax_axes.DP_AXES if multi_pod else (jax_axes.DATA,)
    kvh = cfg.n_kv_heads
    meshes = {"batch": ref_shape(cfg, multi_pod)}
    if 16 % kvh == 0:
        shape = (16, kvh, 16 // kvh)
        names = ("data", "model", "tp")
        if multi_pod:
            shape, names = (2,) + shape, ("pod",) + names
        meshes["kv"] = (shape, names)
        # the port folds `pod` into `data`
        km = kv_split_mesh(cfg, multi_pod)
        assert km.shape == ((32,) + shape[2:] if multi_pod else shape)
    else:
        assert kv_split_mesh(cfg, multi_pod) is None
    for split, (shape, names) in meshes.items():
        jm, pm = stand_in(shape, names), RecordingMesh(shape, names)
        seq, heads = (jax_axes.TP, jax_axes.MODEL) if split == "kv" \
            else (None, None)
        for s in DECODES:
            jc = jax.eval_shape(lambda: jlm.init_cache(
                jcfg, s.global_batch, s.seq_len, jnp.bfloat16))
            cache = lm.init_cache(cfg, s.global_batch, s.seq_len,
                                  device="meta")
            ref = jsh.cache_specs(jcfg, jm, jc)
            ref = ref._replace(kv=_kv_literal(jc.kv.k.ndim - 4, dpx, seq,
                                              heads))
            want = ref_safe(jm, ref, jc)
            got = sh.safe_specs(pm, sh.cache_specs(cfg, pm, cache, split),
                                cache)
            leaves = walk(jc, want, got)
            assert len(leaves) == len(tree_items(cache))
            for path, w, g in leaves:
                assert g == as_spec(w), (split, s.name, path)


def test_without_sequence_parallelism_the_peak_is_as_before():
    res = dryrun.run_cell("qwen3-8b", "train_4k", seq_parallel=False,
                          verbose=False)
    assert res["memory_analysis"]["peak_bytes_estimate"] == 32_138_467_344


def test_sequence_parallelism_drops_at_least_the_saved_carries():
    layers, b, s, d, n = 4, 16, 4096, 8192, 16
    peak = {sp: dryrun.run_cell("qwen2-72b", "train_4k", seq_parallel=sp,
                                layers=layers, verbose=False)
            ["memory_analysis"]["peak_bytes_estimate"] for sp in (True,
                                                                  False)}
    carries = layers * b * s * d * 2 * (n - 1) // n
    assert peak[False] - peak[True] >= carries


# rank 0's all-to-all records (count, raw bytes, wire bytes) of train_4k
# on the default mesh, from the backward that waited for every chunk of dy
# before its FFN backward
A2A_RECORDS = {"gpt2-moe": (288, 1_146_617_856, 1_074_954_240),
               "mixtral-8x22b": (1344, 84_821_409_792, 74_218_733_568)}


@pytest.mark.parametrize("arch", sorted(A2A_RECORDS))
def test_pipelined_backward_keeps_the_all_to_all_records(arch):
    res = dryrun.run_cell(arch, "train_4k", verbose=False)
    assert res["status"] == "ok"
    c = res["collectives"]
    got = (c["counts"]["all-to-all"], c["raw_bytes"]["all-to-all"],
           c["wire_bytes"]["all-to-all"])
    assert got == A2A_RECORDS[arch]
