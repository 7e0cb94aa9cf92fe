"""Dry run of one (arch x shape x mesh) cell on ``meta``: the port's
counterpart of the reference's ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k [--multi-pod] [--mesh DxE] \\
        [--batch B --seq S --layers L] [--json F] \\
        [--no-sp] [--no-lina] [--microbatches N] [--dp-only] \\
        [--kv-split] [--cache-batch-only] [--tag T]

It runs rank 0's train, prefill or decode step (``launch.steps``'
``make_train_step``, ``make_prefill_step``, ``make_decode_step``) on the
kernel route at full width and depth, on the ``meta`` device: every
kernel wrapper runs its contract and allocates its outputs and scratch
there, nothing is launched and no value is computed.  The mesh is a
``RecordingMesh`` (``arch_mesh``: the reference's 16 x 16, or 2 x 16 x 16
with `pod` folded into `data`, its `model` axis split into (`model`,
`tp`) for an arch whose experts do not fill it: mixtral-8x22b's (16, 8,
2)), which records every collective the step issues.  The step is the
dense-sharded one (``launch.sharding``): the inputs are rank 0's shards
as the reference's specs place them:

  * parameters by ``param_specs`` (training) or ``serve_param_specs``
    (prefill, decode: the data axes stripped where bf16 weights over the
    model-parallel ranks fit 10 GB, ``serve_uses_fsdp``), after
    ``safe_spec``;
  * AdamW state by ``opt_state_specs`` (training);
  * the batch by ``batch_specs``: B / dp rows where they split, else the
    whole batch; the decode cache by ``cache_specs`` (its sequence over
    the model-parallel ranks).

Peak memory is counted by ``PeakTracker``, a ``TorchDispatchMode`` that
adds each new storage's bytes and subtracts them when the storage is
freed; the step's peak is the arguments' bytes plus the peak of that sum.

The result keeps the reference's keys where they mean the same:
``memory_analysis`` (argument, output, temp and peak bytes: temp is the
peak of what the step allocates beyond its arguments), the analytic FLOPs
and bytes (``launch.analytic``), ``collectives`` (``launch.hlo_analysis``'s
summary of the records), ``roofline`` (the reference's ``roofline_terms``
on ``configs.H100``), ``model_flops_global``, ``useful_flops_ratio``,
``dominant_term`` and ``roofline_fraction``, and a new ``fits``: peak <=
the card's 80 GB.  The roofline terms are an estimate from the H100 data
sheet (989 TFLOP/s bf16, 3.35 TB/s, NVLink 450 GB/s as one link), not a
measurement, and a 16-way group spans two 8-GPU nodes, so the collective
term (NVLink's rate) is a lower bound.

The reference's variants, with its defaults
(``src/repro/launch/dryrun.py:52-135, 225-241``): Megatron sequence
parallelism is on (``cfg.seq_parallel``; ``--no-sp`` the paper's
baseline), Lina's schedule on (``--no-lina``: one all-to-all, the whole
FFN, one all-to-all), one microbatch (``--microbatches``), tensor
parallelism on (``--dp-only``: ``cfg.tensor_parallel`` False, every axis
FSDP); two decode hill-climbs place the KV cache otherwise:
``--kv-split`` re-views `model` as (kv heads, `tp`)
(``launch.mesh.kv_split_mesh``) and splits the cache's kv heads over
`model` and its sequence over `tp`, ``--cache-batch-only`` splits its
rows alone (``launch.sharding.cache_specs``).  ``--tag`` labels the
result.  Under ``--dp-only`` the reference's carry constraint
``P(dp, tp_axes, None)`` still splits the sequence over `model` (and
`tp`), while every weight is whole after its FSDP gather: so SP keeps
the carry S / n a rank, attention gathers its input and cuts its whole
output back to the slice, and the FFNs run on the slice; the experts'
spec there names `model` once (the reference's names it twice, which
JAX refuses: ``launch.sharding.param_specs``).  Where the kv heads do
not divide 16 the reference's ``kv_split`` names a `tp` axis its mesh
lacks; the port skips such a cell with that reason.

A cell is ``skip`` with its reason where the reference skips it
(``configs.skip_reason``) or where a kernel's contract refuses a shape on
the path (``refused``: a ``KernelRefused``).  Any other fault is
``error``, with its traceback.  A mesh is never substituted.

``step_program`` also builds rank 0's program on a card: with a
``MirrorMesh`` its shards are drawn directly at their local shapes
(``launch.sharding.init_shards``), so that a cell whose whole model does
not fit one card runs there (``chip_smoke.py`` phase 15).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import H100, SHAPES, ShapeConfig, get_config, \
    skip_reason
from repro_torch.convert import shard_params
from repro_torch.kernels._build import KernelRefused
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.hlo_analysis import collective_summary
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch.mesh import (RecordingMesh, arch_mesh,
                                     kv_split_mesh, mesh_axes, parse_mesh)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_serve_plan, make_train_step)
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import DTYPES, FRAME_DIM
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

def roofline_terms(flops_global: float, bytes_global: float,
                   coll_bytes_per_dev: float, n_chips: int, hw=H100) -> dict:
    """The reference's three terms (seconds), on the card's data sheet:
    compute and memory from the analytic model (global / chips), the
    collective term from the recorded per-rank wire bytes."""
    return {
        "compute_s": flops_global / (n_chips * hw.peak_flops),
        "memory_s": bytes_global / (n_chips * hw.hbm_bw),
        "collective_s": coll_bytes_per_dev / (hw.ici_links * hw.ici_bw),
        "collective_s_single_link": coll_bytes_per_dev / hw.ici_bw,
    }


class PeakTracker(TorchDispatchMode):
    """Bytes of the storages created inside the mode: each new storage's
    ``nbytes`` is added when an op first returns it and subtracted when
    the storage is freed.  ``peak`` is the largest sum seen.  Storages
    that existed before (the arguments, and views of them) are not
    counted."""

    def __init__(self):
        super().__init__()
        self.current = 0
        self.peak = 0
        self.allocs = 0
        self._live: dict = {}

    def _free(self, key) -> None:
        self.current -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {a.untyped_storage()._cdata
                for a in tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in seen:
                continue
            self._live[key] = st.nbytes()
            self.current += st.nbytes()
            self.allocs += 1
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, key)
        return out


def storages(*trees) -> dict:
    """{storage key: bytes} of the distinct storages under ``trees``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(trees) if isinstance(t, torch.Tensor)}


def _ids(cfg, shape, device, gen):
    """Random token ids (zeros on ``meta``: no draws)."""
    if torch.device(device).type == "meta":
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device=device, dtype=torch.int32)


def batch_for(cfg, kind: str, b: int, s: int, device, gen=None) -> dict:
    """A step's batch [b, s] on ``device`` (the reference's
    ``batch_struct``): random ids, llava's patches and hubert's frames in
    bf16 (nothing drawn on ``meta``)."""
    def ids(shape):
        return _ids(cfg, shape, device, gen)

    def feats(shape):
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=torch.bfloat16, device=device)
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = feats((b, s, FRAME_DIM))
        if kind == "train":
            out["labels"] = ids((b, s))
        return out
    st = s - cfg.n_patches if cfg.frontend == "vision_stub" else s
    out["tokens"] = ids((b, st))
    if cfg.frontend == "vision_stub":
        out["patches"] = feats((b, cfg.n_patches, cfg.d_model))
    if kind == "train":
        out["labels"] = ids((b, st))
    return out


def _sharded_program(cfg, kind: str, b: int, s: int, mesh, dev, gen,
                     global_batch: int, lina: bool, microbatches: int,
                     cache_split: str):
    """``step_program`` with a mesh: the dense-sharded step and rank's
    shards (see the module doc)."""
    full = lm_mod.init_params(cfg, None, device="meta")
    cache = None
    if kind == "decode":
        cache = lm_mod.init_cache(cfg, global_batch, s,
                                  dtype=DTYPES[cfg.dtype], device="meta")
    layout = shard_mod.layout_for(cfg, mesh, full, kind,
                                  global_batch=global_batch, cache=cache,
                                  cache_split=cache_split)
    mirror = dev.type != "meta" and isinstance(mesh, RecordingMesh)
    if not mirror:
        params = shard_params(lm_mod.init_params(cfg, gen, device=dev),
                              mesh, layout.specs)
    else:                   # a MirrorMesh: the shards alone fit the card
        params = shard_mod.init_shards(cfg, full, mesh, layout.specs, gen,
                                       dev)

    def ids(t):
        # in a world of equal ranks a token outside this rank's block of
        # a vocab-sharded embedding is looked up by no rank (its row
        # zero through every layer): a mirror's ids stay inside the block
        return t % params.embed.shape[0] if mirror else t

    batch = {k: ids(v) if k in ("tokens", "labels") else v
             for k, v in batch_for(cfg, kind, b, s, dev, gen).items()}
    if kind == "train":
        opt = init_opt_state(params, AdamWConfig(
            state_dtype=cfg.opt_state_dtype))
        step = make_train_step(cfg, layout=layout, lina=lina,
                               dispatch_backend="pallas",
                               microbatches=microbatches)
        return step, (params, opt, batch)
    params = lm_mod.cast_for_compute(cfg, params)
    plan = make_serve_plan(cfg, mesh, device=dev)
    if kind == "prefill":
        step = make_prefill_step(cfg, layout, serve_plan=plan)
        return _no_grad(step), (params, batch)
    local = shard_mod.local_zeros(cache, mesh, layout.cache_specs, dev)
    local = local._replace(pos=torch.full_like(local.pos, s - 1))
    token = ids(_ids(cfg, (b,), dev, gen))
    step = make_decode_step(cfg, layout, serve_plan=plan)
    return _no_grad(step), (params, local, token)


def step_program(cfg, kind: str, b: int, s: int, *, mesh=None,
                 device="meta", global_batch: int | None = None,
                 lina: bool = True, microbatches: int = 1,
                 cache_split: str = "seq"):
    """(step, args): rank 0's ``kind`` step ("train", "prefill",
    "decode") and its arguments on ``device``, so that ``step(*args)``
    runs it once.  The same program on ``meta`` (the dry run) and on the
    card (``chip_smoke.py`` holds the dry run's peak against the card's).
    ``b`` is rank 0's batch, ``s`` the sequence (decode: the cache's
    depth).  With a ``mesh`` the step is dense-sharded by the reference's
    specs (``global_batch``: the batch whose rows ``b`` are rank 0's,
    which decides whether they split over the data axes); without, the
    one-rank step.  ``lina`` and ``microbatches`` are the train step's
    (the reference's serve steps take neither), ``cache_split`` the
    decode cache's placement (``launch.sharding.cache_specs``).  Off
    ``meta`` the weights and inputs are drawn from seed 0."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    if mesh is not None:
        return _sharded_program(cfg, kind, b, s, mesh, dev, gen,
                                global_batch or b, lina, microbatches,
                                cache_split)
    params = lm_mod.init_params(cfg, gen, device=dev)
    if kind == "train":
        opt = init_opt_state(params, AdamWConfig(
            state_dtype=cfg.opt_state_dtype))
        # the trainer's step: dispatch and combine on the kernel route
        step = make_train_step(cfg, dispatch_backend="pallas", lina=lina,
                               microbatches=microbatches)
        return step, (params, opt, batch_for(cfg, kind, b, s, dev, gen))
    params = lm_mod.cast_for_compute(cfg, params)      # the served copy
    plan = make_serve_plan(cfg, None, device=dev)
    if kind == "prefill":
        step = make_prefill_step(cfg, serve_plan=plan)
        return _no_grad(step), (params, batch_for(cfg, kind, b, s, dev, gen))
    cache = lm_mod.init_cache(cfg, b, s, dtype=DTYPES[cfg.dtype], device=dev)
    cache = cache._replace(pos=torch.full_like(cache.pos, s - 1))
    token = _ids(cfg, (b,), dev, gen)
    step = make_decode_step(cfg, serve_plan=plan)
    return _no_grad(step), (params, cache, token)


def _no_grad(step):
    def run(*args):
        with torch.no_grad():
            return step(*args)
    return run


def meta_peak(step, args) -> dict:
    """Run ``step(*args)`` on ``meta`` under a ``PeakTracker``: argument,
    output, temp and peak bytes (the reference's ``memory_analysis``)."""
    held = storages(args)
    arg = sum(held.values())
    with PeakTracker() as pt:
        out = step(*args)
    outb = sum(n for k, n in storages(out).items() if k not in held)
    return {"argument_bytes": int(arg), "output_bytes": int(outb),
            "temp_bytes": int(pt.peak),
            "peak_bytes_estimate": int(arg + pt.peak),
            "allocations": pt.allocs}


def cell_shape(cfg, shape: ShapeConfig, mesh) -> tuple:
    """(rank 0's batch, sequence) of ``shape`` on ``mesh``: its rows
    over the data axes where they split (``sharding.batch_specs``)."""
    b = shape.global_batch
    if shard_mod.batch_split(mesh, b):
        b //= shard_mod.axis_size(mesh, shard_mod.axes.dp_axes(mesh))
    return b, shape.seq_len


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             lina: bool = True, seq_parallel: bool = True,
             microbatches: int = 1, cache_batch_only: bool = False,
             dp_only: bool = False, kv_split: bool = False, tag: str = "",
             mesh_shape=None, batch=None, seq=None, layers=None,
             verbose: bool = True) -> dict:
    """One cell (see the module doc): ``ok``, ``skip`` with its reason, or
    ``error`` with the traceback of a fault that is no kernel's refusal.
    The keywords before ``mesh_shape`` are the reference's, with its
    defaults.  ``kv_split`` re-views the cell's production mesh
    (``kv_split_mesh``), so it takes no ``mesh_shape``."""
    if kv_split and mesh_shape:
        raise ValueError("kv_split re-views the production mesh's `model` "
                         "axis as (model, tp): give no mesh_shape")
    cfg = dataclasses.replace(get_config(arch), seq_parallel=seq_parallel,
                              tensor_parallel=not dp_only)
    if layers:
        pattern = cfg.layer_pattern[:layers - 1] + "*" \
            if cfg.layer_pattern else ""
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  layer_pattern=pattern)
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = ShapeConfig(shape.name, seq or shape.seq_len,
                            batch or shape.global_batch, shape.kind)
    mesh = RecordingMesh(mesh_shape, mesh_axes(mesh_shape)) if mesh_shape \
        else arch_mesh(cfg, multi_pod)
    mesh_name = "x".join(map(str, mesh_shape)) if mesh_shape else \
        ("2x16x16" if multi_pod else "16x16")
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if not reason and kv_split:
        mesh = kv_split_mesh(cfg, multi_pod)
        if mesh is None:
            reason = (f"kv_split: {cfg.n_kv_heads} kv heads do not divide "
                      f"the 16-way model axis")
    if reason:
        return {**head, "status": "skip", "reason": reason}
    if shape.kind == "long_decode":
        kind = "decode"
    else:
        kind = shape.kind
    b, s = cell_shape(cfg, shape, mesh)
    t0 = time.time()
    try:
        cache_split = "kv" if kv_split else \
            "batch" if cache_batch_only else "seq"
        step, args = step_program(cfg, kind, b, s, mesh=mesh,
                                  global_batch=shape.global_batch,
                                  lina=lina, microbatches=microbatches,
                                  cache_split=cache_split)
        mesh.records.clear()
        mem = meta_peak(step, args)
    except KernelRefused as e:
        return {**head, "status": "skip", "reason": f"refused: {e}"}
    except Exception:
        return {**head, "status": "error",
                "error": traceback.format_exc()[-2000:]}
    t_run = time.time() - t0
    coll = collective_summary(mesh.records)
    ana = analytic_cost(cfg, shape)
    n_chips = mesh.world
    terms = roofline_terms(ana.flops_global, ana.hbm_bytes_global,
                           coll["total_wire_bytes"], n_chips)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    result = {
        **head, "mesh_shape": list(mesh.shape), "n_chips": n_chips,
        "status": "ok", "lina": lina, "seq_parallel": seq_parallel,
        "microbatches": microbatches, "dp_only": dp_only,
        "kv_split": kv_split, "cache_batch_only": cache_batch_only,
        "tag": tag,
        "layers": cfg.n_layers, "rank0_batch": b, "seq": s,
        "run_s": round(t_run, 1),
        "analytic_flops_global": ana.flops_global,
        "analytic_hbm_bytes_global": ana.hbm_bytes_global,
        "collectives": coll,
        "memory_analysis": mem,
        "fits": mem["peak_bytes_estimate"] <= H100.hbm_bytes,
        "roofline": terms,
        "model_flops_global": float(model_flops),
        "useful_flops_ratio": float(model_flops / max(ana.flops_global, 1)),
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    result["dominant_term"] = dom
    result["roofline_fraction"] = terms["compute_s"] / max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])
    if verbose:
        print(f"== {arch} x {shape_name} on {mesh_name} {list(mesh.shape)} "
              f"({n_chips} ranks), rank 0: batch {b} x {s}, {cfg.n_layers} "
              f"layers, lina={lina} seq_parallel={seq_parallel} "
              f"microbatches={microbatches} ==")
        print(f"memory_analysis: {mem} fits={result['fits']}")
        print(f"analytic: flops={ana.flops_global:.3e} "
              f"hbm={ana.hbm_bytes_global:.3e} ({ana.notes})")
        print(f"collectives: {coll['counts']} -> "
              f"{coll['total_wire_bytes'] / 1e9:.3f} GB wire/rank "
              f"{ {k: round(v / 1e9, 3) for k, v in coll['wire_bytes'].items()} }")
        print(f"roofline (H100 data sheet): compute="
              f"{terms['compute_s'] * 1e3:.2f}ms memory="
              f"{terms['memory_s'] * 1e3:.2f}ms collective="
              f"{terms['collective_s'] * 1e3:.2f}ms dominant={dom} "
              f"useful_ratio={result['useful_flops_ratio']:.2f} "
              f"fraction={result['roofline_fraction']:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (pod folded into data)")
    ap.add_argument("--mesh", default=None,
                    help="another recording mesh DxE or DxExT (e.g. 2x2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch instead")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length instead")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--no-lina", action="store_true",
                    help="baseline schedule (one all-to-all, no micro-ops)")
    ap.add_argument("--no-sp", action="store_true",
                    help="no sequence parallelism (the paper's baseline)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cache-batch-only", action="store_true",
                    help="decode: split the KV cache over its rows alone")
    ap.add_argument("--dp-only", action="store_true",
                    help="no tensor parallelism: every axis FSDP / data")
    ap.add_argument("--kv-split", action="store_true",
                    help="decode: re-view `model` as (kv heads x tp), the "
                    "cache's kv heads over it and its sequence over tp")
    ap.add_argument("--tag", default="", help="a label for the result")
    ap.add_argument("--json", default=None, help="append the result here")
    args = ap.parse_args(argv)
    if args.kv_split and args.mesh:
        ap.error("--kv-split re-views the production mesh: drop --mesh")
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   lina=not args.no_lina, seq_parallel=not args.no_sp,
                   microbatches=args.microbatches,
                   cache_batch_only=args.cache_batch_only,
                   dp_only=args.dp_only, kv_split=args.kv_split,
                   tag=args.tag,
                   mesh_shape=parse_mesh(args.mesh) if args.mesh else None,
                   batch=args.batch, seq=args.seq, layers=args.layers)
    if res["status"] == "skip":
        print(f"== {args.arch} x {args.shape} on {res['mesh']}: skip "
              f"({res['reason']})")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "a") as f:
            f.write(json.dumps(res) + "\n")
    return 0 if res["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
