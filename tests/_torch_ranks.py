"""Spawned gloo ranks for the port's multi-rank CPU tests.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes, each
joining a gloo group through a rendezvous file under ``tmp_path`` (so
parallel test workers never share a port), runs ``fn(rank, *args)`` with
one thread and returns every rank's result.  ``fn`` must live in a module
that imports only torch, numpy and the port (this one, for the tests'
rank bodies), since every rank imports it.
"""
from __future__ import annotations

import os
import pickle
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# a collective that waits longer than this raises, so a rank that never
# joins fails the test instead of hanging it
TIMEOUT = timedelta(seconds=180)


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    tmp = Path(tmp_path) / f"ranks_{fn.__name__}_{os.getpid()}"
    n = 0
    while (tmp.parent / f"{tmp.name}_{n}").exists():
        n += 1
    tmp = tmp.parent / f"{tmp.name}_{n}"
    tmp.mkdir(parents=True)
    mp.spawn(_entry, args=(fn, world, str(tmp), args), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def np_tree(t):
    """Tensors of a nested structure -> numpy (for pickling results)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.detach().numpy()
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(np_tree(v) for v in t) if not hasattr(t, "_fields") \
            else [np_tree(v) for v in t]
    return t


# ---------------------------------------------------------------------------
# rank bodies (each runs on every rank of a spawned gloo group)
# ---------------------------------------------------------------------------

def a2a_body(rank, inp_path, shape):
    """all_to_all_ec, its inverse and chunked_all_to_all on a (1, n) mesh,
    and the exchange Function's gradient against the inverse exchange."""
    import numpy as np
    from repro_torch.core import microop
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, device="cpu")
    inp = np.load(inp_path)
    buf = torch.from_numpy(inp["bufs"][rank])              # [E, C, d]
    e = buf.shape[0]
    fwd = microop.all_to_all_ec(buf, mesh)
    inv = microop.all_to_all_ec_inverse(buf, mesh, e)
    chunks = microop.chunked_all_to_all(buf, mesh, 3)
    ichunks = microop.chunked_all_to_all(buf, mesh, 4, inverse=True,
                                         n_experts=e)
    x = buf.clone().requires_grad_()
    ct = torch.from_numpy(inp["cts"][rank])
    (microop.all_to_all_ec(x, mesh) * ct).sum().backward()
    want_grad = microop.all_to_all_ec_inverse(ct, mesh, e)
    return {"fwd": fwd.numpy(), "inv": inv.numpy(),
            "chunked": torch.cat(chunks, 1).numpy(), "n_chunked": len(chunks),
            "ichunked": torch.cat(ichunks, 1).numpy(),
            "n_ichunked": len(ichunks),
            "grad": x.grad.numpy(), "want_grad": want_grad.numpy()}


def pipeline_body(rank, inp_path, counts):
    """pipelined_expert_ffn against the serial form (one a2a, the expert
    function on everything, one a2a) for each requested chunk count."""
    import numpy as np
    from repro_torch.core import microop
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 4), device="cpu")
    inp = np.load(inp_path)
    buf = torch.from_numpy(inp["bufs"][rank])              # [E, C, d]
    w = torch.from_numpy(inp["w"][rank])                   # [E_local, d, d]
    e = buf.shape[0]
    ep = 4
    calls = []

    def fn(rows, start):
        calls.append((rows.shape[1], start))
        r = rows.reshape(ep, e // ep, rows.shape[1], -1)
        out = torch.tanh(torch.einsum("secd,edf->secf", r, w))
        return out.reshape(rows.shape)

    serial = microop.all_to_all_ec_inverse(
        fn(microop.all_to_all_ec(buf, mesh), 0), mesh, e)
    out = {"serial": serial.numpy()}
    for n in counts:
        calls.clear()
        got, side, _ = microop.pipelined_expert_ffn(
            buf, fn, mesh, n, e, shadow=lambda: buf.sum())
        out[n] = (got.numpy(), list(calls), float(side))
    calls.clear()
    got, _, _ = microop.pipelined_expert_ffn(buf, fn, mesh, 4, e,
                                             pipeline=False)
    out["no_pipeline"] = (got.numpy(), list(calls))
    return out


# the layer-parity cases of test_torch_moe_ep: name -> (lina, n_microops,
# ffn_type, top_k, fsdp, shortcut, compute_backend)
MOE_CASES = {
    "lina": (True, 2, "swiglu", 2, False, False, "xla"),
    "no_lina": (False, 2, "swiglu", 2, False, False, "xla"),
    "microops_1": (True, 1, "swiglu", 2, False, False, "xla"),
    "microops_3": (True, 3, "swiglu", 2, False, False, "xla"),
    "gelu_top1": (True, 2, "gelu", 1, False, False, "xla"),
    "fsdp": (True, 2, "swiglu", 2, True, False, "xla"),
    "shortcut": (True, 2, "swiglu", 2, False, True, "xla"),
    "kernel_route": (True, 2, "gelu", 2, False, False, "auto"),
}


def _moe_run(mesh, t, lina, nmo, ffn, k, fsdp, sc, backend):
    """moe_layer on this rank's (batch, sequence) slice of the inputs
    ``t``: its y, aux, ids, probs and gradients of sum(y * ct) (x,
    router, experts, shortcut)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.convert import shard_params
    from repro_torch.core.moe import MoEParams, moe_layer
    from repro_torch.launch.sharding import expert_specs
    dp_n, ep_n = mesh.shape
    d, m = mesh.index("data"), mesh.index("model")
    b = t["x"].shape[0] // dp_n
    s = t["x"].shape[1] // ep_n
    cfg = MoEConfig(n_experts=t["wi"].shape[0], top_k=k,
                    d_ff=t["wi"].shape[2], n_microops=nmo,
                    compute_backend=backend)
    full = MoEParams(t["router"], t["wi"],
                     t["wu"] if ffn == "swiglu" else None, t["wo"])
    ps = MoEParams(*(None if a is None else a.clone().requires_grad_()
                     for a in shard_params(full, mesh, expert_specs(
                         mesh, full, fsdp))))
    scp = None
    if sc:
        scp = tuple(t[k].clone().requires_grad_()
                    for k in ("sc_in", "sc_up", "sc_out"))
    x = t["x"][d * b:(d + 1) * b, m * s:(m + 1) * s].clone() \
        .requires_grad_()
    ct = t["ct"][d * b:(d + 1) * b, m * s:(m + 1) * s]
    o = moe_layer(x, ps, cfg, ffn_type=ffn, mesh=mesh, lina=lina,
                  fsdp=fsdp, shortcut_params=scp)
    (o.y * ct).sum().backward()
    return {"y": o.y.detach().numpy(),
            "aux": float(o.aux_loss.detach()),
            "eidx": o.expert_idx.numpy(),
            "probs": o.router_probs.detach().numpy(),
            "gx": x.grad.numpy(),
            "grads": {f: getattr(ps, f).grad.numpy()
                      for f in ps._fields
                      if getattr(ps, f) is not None},
            "gsc": [a.grad.numpy() for a in scp] if scp else None}


def moe_body(rank, inp_path, shape, cases):
    """Every case of MOE_CASES on a (2, 4) mesh: this rank's y, aux, ids,
    probs and gradients of sum(y * ct) (x, router, experts, shortcut)."""
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, device="cpu")
    inp = np.load(inp_path)
    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    return {name: _moe_run(mesh, t, *MOE_CASES[name]) for name in cases}


def rows_stable(m: int, n: int, d: int, f: int) -> bool:
    """Whether the plain matmul gives each row of a [2, m, k] @ [k, j]
    product (k, j = d, f and f, d: the FFN's, forward and backward) the
    same bits as that row of the whole [2, m * n, k] product (on a CPU it
    may depend on M)."""
    g = torch.Generator().manual_seed(0)
    for k, j in ((d, f), (f, d)):
        a = torch.randn(2, m * n, k, generator=g)
        b = torch.randn(2, k, j, generator=g)
        whole = torch.matmul(a, b)
        for i in range(n):
            part = a[:, i * m:(i + 1) * m].contiguous()
            if not torch.equal(torch.matmul(part, b),
                               whole[:, i * m:(i + 1) * m]):
                return False
    return True


SECTION_MICROOPS = 4        # lina_body's section: 4 of C 6 resolves to 3


def lina_body(rank, inp_path, shape, cases, section):
    """On a ``shape`` mesh, the kernel route (the kernels' plain versions
    here) with ``lina`` and without, for each (ffn_type, n_microops) of
    ``cases`` (``_moe_run``); the expert-parallel section alone on the
    capacity buffer ``section`` ([E, C, d] per rank; its C need not be a
    multiple of 8) with SECTION_MICROOPS micro-ops against one, for each
    ffn_type; the chunk counts resolved; and ``rows_stable`` at the row
    counts of both."""
    import numpy as np
    from repro_torch.core import axes
    from repro_torch.core.gating import capacity
    from repro_torch.core.microop import resolve_chunk_count
    from repro_torch.core.moe import _ExpertParallel, _Plan
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, device="cpu")
    inp = np.load(inp_path)
    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    ep = mesh.size(axes.EP_AXIS)
    out = {}
    for ffn, nmo in cases:
        out[ffn, nmo] = {lina: _moe_run(mesh, t, lina, nmo, ffn, 2, False,
                                        False, "auto")
                         for lina in (True, False)}
    e, el = t["wi"].shape[0], t["wi"].shape[0] // ep
    m = mesh.index("model")
    buf = t[section][rank]
    wi, wu, wo = (t[k][m * el:(m + 1) * el] for k in ("wi", "wu", "wo"))
    for ffn in ("gelu", "swiglu"):
        for nmo in (SECTION_MICROOPS, 1):
            ws = [a.clone().requires_grad_() for a in (wi, wu, wo)]
            if ffn == "gelu":
                ws[1] = None
            x = buf.clone().requires_grad_()
            plan = _Plan(mesh, e, nmo, True, ffn, "pallas", None, None)
            y = _ExpertParallel.apply(x, *ws, plan)
            (y * t["ct_" + section][rank]).sum().backward()
            out["section", ffn, nmo] = [y.detach().numpy(), x.grad.numpy()] \
                + [a.grad.numpy() for a in ws if a is not None]
    b, s = t["x"].shape[0] // shape[0], t["x"].shape[1] // shape[1]
    c = capacity(b * s, e, 2, 1.25)
    out["n_layer"] = {nmo: resolve_chunk_count(c, nmo) for _, nmo in cases}
    out["n_section"] = resolve_chunk_count(buf.shape[1], SECTION_MICROOPS)
    d, f = t["wi"].shape[1:]
    out["rows_stable"] = all(
        rows_stable(ep * c // n, n, d, f)
        for n in out["n_layer"].values()) and rows_stable(
        ep * buf.shape[1] // out["n_section"], out["n_section"], d, f)
    return out


def reduce_tree(rank, seed: int = 0):
    """A gradient tree with replicated and expert leaves, perturbed by
    rank: a dense matrix, a bias and a MoEParams (router, wi, wo)."""
    import numpy as np
    from repro_torch.core.moe import MoEParams
    rng = np.random.RandomState(seed)
    base = {"dense": rng.randn(24, 16), "bias": rng.randn(40),
            "router": rng.randn(16, 4), "wi": rng.randn(2, 16, 8),
            "wo": rng.randn(2, 8, 16)}
    delta = {k: rng.randn(*v.shape) for k, v in base.items()}
    t = {k: torch.from_numpy((base[k] + 0.25 * (rank + 1) * delta[k])
                             .astype(np.float32)) for k in base}
    return {"dense": t["dense"], "bias": t["bias"],
            "moe": MoEParams(t["router"], t["wi"], None, t["wo"])}


def reduce_body(rank, shape, combos, partition_bytes):
    """reduce_gradients on a mesh of ``shape`` for each (schedule,
    compression): the reduced leaves, the plan's chunk counts, and the
    int8 state after two reductions."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import expert_specs
    from repro_torch.optim import reduce as R
    from repro_torch.tree import tree_leaves
    mesh = make_mesh(shape, device="cpu")
    grads = reduce_tree(rank)
    specs = expert_specs(mesh, grads)
    out = {}
    for sched, comp in combos:
        cfg = R.ReduceConfig(sched, partition_bytes=partition_bytes,
                             compression=comp)
        state = R.init_reduce_state(grads, cfg)
        red, state = R.reduce_gradients(mesh, grads, cfg, state=state,
                                        specs=specs)
        pend, _ = R.reduce_gradients(mesh, grads, cfg, state=state,
                                     async_op=True, specs=specs)
        again = pend.wait()
        out[(sched, comp)] = {
            "red": [r.numpy() for r in tree_leaves(red)],
            "again": [r.numpy() for r in tree_leaves(again)],
            "plan": [(idx, n) for idx, _, _, n in
                     R.reduce_plan(mesh, grads, cfg, specs)],
            "residual": None if state is None else
            [r.numpy() for r in tree_leaves(state.int8.residual)]}
    return out


def _smoke(**moe):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("gpt2-moe-smoke")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) \
        if moe else cfg


def _local_batch(cfg, step, mesh, global_batch=8, seq=32):
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=global_batch))
    w = 1 if mesh is None else mesh.world
    r = 0 if mesh is None else mesh.rank
    b = global_batch // w
    return {k: torch.from_numpy(v[r * b:(r + 1) * b])
            for k, v in data.batch(step).items()}


def full_params(cfg, seed: int = 0):
    from repro_torch.models import lm
    gen = torch.Generator()
    gen.manual_seed(seed)
    return lm.init_params(cfg, gen, device="cpu")


def schedules_body(rank, combos, steps, microbatches):
    """Each (schedule, compression) trains gpt2-moe-smoke ``steps`` steps
    on a (2, 2) mesh from the same seed, the experts alone sharded
    (``expert_layout``: the replicated leaves take the schedules); rank 0
    returns the full params (gathered), every rank its losses."""
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import expert_layout
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import reduce as R
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_leaves
    mesh = make_mesh((2, 2), device="cpu")
    cfg = _smoke()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    out = {}
    for sched, comp in combos:
        full = full_params(cfg)
        layout = expert_layout(mesh, full)
        params = shard_params(full, mesh, layout.specs)
        opt = init_opt_state(params, ocfg)
        step = make_train_step(cfg, ocfg, layout=layout, schedule=sched,
                               grad_compression=comp,
                               microbatches=microbatches,
                               dispatch_backend="pallas")
        rstate = R.init_reduce_state(params, R.ReduceConfig(
            sched, compression=comp)) if comp == "int8_ef" else None
        losses = []
        for s in range(steps):
            batch = _local_batch(cfg, s, mesh)
            if rstate is not None:
                params, opt, m, rstate = step(params, opt, batch, rstate)
            else:
                params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        full = unshard_params(params, mesh, layout.specs)
        out[(sched, comp)] = {
            "losses": losses,
            "params": [p.numpy() for p in tree_leaves(full)]
            if rank == 0 else None}
    return out


def grads_config(remat: bool):
    """gpt2-moe-smoke at no-drop capacity and aux weight 0; with
    ``remat`` also recomputing each layer group (all-to-alls included) in
    the backward, and the ScMoE shortcut on."""
    import dataclasses
    cfg = _smoke(capacity_factor=4.0, aux_loss_weight=0.0, shortcut=remat)
    return dataclasses.replace(cfg, remat=remat)


def grads_body(rank, remat, fsdp=False):
    """The (2, 2) step's reduced gradients (``grads_config``; with
    ``fsdp`` the experts' hidden dims also split over `data`), gathered to
    full shapes (rank 0), their global norm and the loss."""
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import expert_layout
    from repro_torch.launch.steps import global_grad_norm, make_train_step
    from repro_torch.tree import tree_leaves
    mesh = make_mesh((2, 2), device="cpu")
    cfg = grads_config(remat)
    full = full_params(cfg)
    layout = expert_layout(mesh, full, fsdp=fsdp)
    params = shard_params(full, mesh, layout.specs)
    step = make_train_step(cfg, layout=layout, schedule="priority+partition",
                           partition_bytes=4096, dispatch_backend="pallas")
    grads, loss, _, _ = step.reduced_grads(params, _local_batch(cfg, 0, mesh))
    norm = float(global_grad_norm(mesh, grads, layout.specs))
    full = unshard_params(grads, mesh, layout.specs)
    return {"loss": float(loss), "norm": norm,
            "grads": [g.numpy() for g in tree_leaves(full)]
            if rank == 0 else None}


def _trainer(cfg, root, mesh, **kw):
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    tcfg = TrainerConfig(steps=kw.pop("steps", 4), ckpt_every=2,
                         ckpt_dir=root, device="cpu", **kw)
    return Trainer(cfg, dcfg, ocfg, tcfg, mesh=mesh)


TRAINER_KW = dict(schedule="priority+partition+pipeline", microbatches=2,
                  grad_compression="int8_ef", n_microops=2)


def resume_body(rank, root):
    """On a (2, 2) mesh: 4 straight steps against 2 + injected failure +
    restart + 2; this rank's states and both runs' losses."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves
    mesh = make_mesh((2, 2), device="cpu")
    cfg = _smoke()
    straight = _trainer(cfg, f"{root}/a", mesh, **TRAINER_KW)
    want = straight.run()
    failing = _trainer(cfg, f"{root}/b", mesh, fail_at_step=2, **TRAINER_KW)
    try:
        failing.run()
    except RuntimeError as e:
        assert "injected failure at step 2" in str(e)
    else:
        raise AssertionError("the injected failure did not fire")
    resumed = _trainer(cfg, f"{root}/b", mesh, **TRAINER_KW)
    got = resumed.run()
    return {"want": [t.numpy() for t in tree_leaves(want)],
            "got": [t.numpy() for t in tree_leaves(got)],
            "straight": [r["loss"] for r in straight.metrics_log],
            "resumed": [r["loss"] for r in failing.metrics_log
                        + resumed.metrics_log],
            "knobs": (straight.model_cfg.moe.n_microops,
                      straight.packing_decision)}


def restore_1x1_body(rank, root):
    """A (2, 2) run's checkpoint restored on a (1, 1) mesh: the state it
    restores (no step left to run) and the residuals it zeroed."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_items
    mesh = make_mesh((1, 1), device="cpu")
    tr = _trainer(_smoke(), root, mesh, **TRAINER_KW)
    state = tr.run()
    return {"state": {k: v.numpy() for k, v in tree_items(state)},
            "reset": tr.reset_log}


def one_rank_body(rank, flags):
    """The driver's step on a (1, 1) mesh and without one, 4 steps each
    from the same seed: both runs' losses and final params."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import tree_leaves
    mesh = make_mesh((1, 1), device="cpu")
    out = []
    for extra in ([], ["--mesh", "1x1", *flags]):
        args = train.parse_args(["--arch", "gpt2-moe-smoke", "--device",
                                 "cpu", "--steps", "12", "--batch", "8",
                                 "--seq", "32", "--ckpt-dir", "unused",
                                 "--microbatches", "2", *extra])
        cfg, dcfg, ocfg, tcfg = train.configs(args)
        tr = Trainer(cfg, dcfg, ocfg, tcfg,
                     mesh=mesh if args.mesh else None)
        st, losses = tr.init_state(), []
        for i in range(4):
            p, o, m = tr.step_fn(st["params"], st["opt_state"], tr._batch(i))
            st = {"params": p, "opt_state": o}
            losses.append(float(m["loss"]))
        out.append((losses, [t.numpy() for t in tree_leaves(st)]))
    return out


# ---------------------------------------------------------------------------
# serving on a mesh (test_torch_serve_ep, test_torch_serve_steps)
# ---------------------------------------------------------------------------

# the layer-parity cases of test_torch_serve_ep on a (2, 4) mesh: name ->
# (route_mode, top_k, ffn_type, compute_backend, n_dev, tokens, replicas
# (None: plan_placement; r: r of every expert), cap_override, dead devices)
SERVE_CASES = {
    "weighted_top1_gelu_xla": ("weighted", 1, "gelu", "xla", 4, 64, None,
                               0, ()),
    "round_robin_top2_swiglu_pallas_group2": (
        "round_robin", 2, "swiglu", "pallas", 8, 64, None, 0, ()),
    "weighted_top2_pallas_min_replicas2": (
        "weighted", 2, "gelu", "pallas", 8, 64, 2, 0, ()),
    "weighted_63_tokens_swiglu_xla": ("weighted", 1, "swiglu", "xla", 4, 63,
                                      None, 0, ()),
    "round_robin_cap_override_xla": ("round_robin", 1, "gelu", "xla", 8, 64,
                                     None, 8, ()),
    "weighted_dead_device_swiglu_pallas": (
        "weighted", 2, "swiglu", "pallas", 8, 64, None, 0, (3,)),
}
# capacity factor of the layer cases: tight enough that a token shard
# drops tokens, so sharding the tokens changes the numbers
SERVE_CF = 0.5


def serve_layer_body(rank, inp_path, shape):
    """Every case of SERVE_CASES through ``serve_moe_layer`` on a mesh of
    ``shape``: the global y, ids and probs this rank returns, whether a
    pre-fetched hosted stack gives the same bits, whether ``fetch_hosted``
    is the whole stack's hosted rows, and ``dp_shard_count``."""
    import numpy as np
    from repro_torch.configs.base import MoEConfig
    from repro_torch.convert import shard_params
    from repro_torch.core import serving
    from repro_torch.core.moe import MoEParams
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import expert_specs
    mesh = make_mesh(shape, device="cpu")
    inp = np.load(inp_path)
    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    out = {"dp_shard_count": [serving.dp_shard_count(mesh, n)
                              for n in (64, 63, 2)]}
    for name, (route, k, ffn, backend, n_dev, n_tok, _, cap,
               _) in SERVE_CASES.items():
        cfg = MoEConfig(n_experts=t["wi"].shape[0], top_k=2,
                        d_ff=t["wi"].shape[2], capacity_factor=SERVE_CF,
                        compute_backend=backend)
        full = MoEParams(t["router"], t["wi"],
                         t["wu"] if ffn == "swiglu" else None, t["wo"])
        ps = shard_params(full, mesh, expert_specs(mesh, full))
        plan = serving.PlanArrays(*(t[f"{name}/{f}"] for f in (
            "slot_expert", "replica_of", "n_replicas", "route_weight")))
        kw = dict(ffn_type=ffn, top_k=k,
                  min_replicas=int(plan.n_replicas.min()), cap_override=cap,
                  route_mode=route, mesh=mesh)
        x = t["x"][:n_tok]
        y, eidx, probs = serving.serve_moe_layer(x, ps, cfg, plan, **kw)
        hw = serving.fetch_hosted(ps, plan, mesh)
        y2, _, _ = serving.serve_moe_layer(x, ps, cfg, plan, hosted=hw, **kw)
        safe = torch.clamp(serving.hosted_slots(plan, mesh), min=0).long()
        fetched_exact = all(
            torch.equal(a, w[safe]) for a, w in
            zip(hw, (full.wi, full.wu, full.wo)) if w is not None)
        out[name] = {"y": y.numpy(), "eidx": eidx.numpy(),
                     "probs": probs.numpy(),
                     "prefetched_bitwise": torch.equal(y, y2),
                     "fetched_exact": fetched_exact}
    return out


def params_from_npz(cfg, path):
    """The port's ``LMParams`` of ``cfg`` with the leaves of an ``.npz``
    keyed by ``tree_items`` path (the reference's params, converted)."""
    import numpy as np
    from repro_torch.tree import tree_items, tree_unflatten_like
    like = full_params(cfg)
    arrs = np.load(path)
    return tree_unflatten_like(like, [torch.from_numpy(arrs[p])
                                      for p, _ in tree_items(like)])


def _stats(stats):
    return [{"layer": s.layer, "finetuned": s.finetuned,
             "est_accurate": s.est_accurate, "plan_reused": s.plan_reused,
             "n_tokens": s.n_tokens, "replica_load": s.replica_load,
             "est_pop": s.est_pop, "actual_pop": s.actual_pop,
             "device_load": s.device_load} for s in stats]


SLOW_RANK, SLOW_S = 1, 0.02     # the simulate check's slowed rank and sleep


def serve_server_body(rank, params_path, inp_path):
    """``MoEServer`` on a (2, 2) mesh with the reference's weights: the
    profile, serve_batch, prefill and two decode steps; then ``simulate``
    with rank SLOW_RANK sleeping SLOW_S in every dispatch."""
    import time
    import numpy as np
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                            simulate)
    from repro_torch.runtime.server import MoEServer, profile_from_training
    mesh = make_mesh((2, 2), device="cpu")
    cfg = _smoke()
    params = params_from_npz(cfg, params_path)
    inp = np.load(inp_path)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(3)), mesh=mesh)
    srv = MoEServer(cfg, params, prof, mesh=mesh)
    out = {"counts": prof.counts}
    with torch.inference_mode():
        r = srv.serve_batch(inp["serve_tokens"])
        out["serve"] = (r.logits, r.path_ids, _stats(r.stats))
        pre = srv.prefill_batch(inp["tokens"], lengths=inp["lengths"],
                                path_init=inp["path_init"],
                                cache_len=inp["tokens"].shape[1] + 2)
        out["prefill"] = (pre.logits, pre.path_ids, _stats(pre.stats))
        lengths = inp["lengths"]
        b = lengths.shape[0]
        state = pre.path_ids[np.arange(b), np.maximum(lengths - 1, 0)]
        cache, nxt, valid = pre.cache, inp["next"], lengths > 0
        out["decode"] = []
        for _ in range(2):
            d = srv.decode_batch(nxt, cache, state, valid=valid)
            out["decode"].append((d.logits, d.path_state, _stats(d.stats)))
            cache, state = d.cache, d.path_state
            nxt = np.argmax(d.logits, axis=-1)
        if rank == SLOW_RANK:
            real = srv._dispatch

            def slow(*a, **kw):
                time.sleep(SLOW_S)
                return real(*a, **kw)
            srv._dispatch = slow
        eng = ServingEngine(srv, EngineConfig(max_batch_tokens=64,
                                              max_batch_requests=4))
        trace = [(inp["trace_tokens"][i], float(inp["trace_at"][i]))
                 for i in range(inp["trace_at"].shape[0])]
        res = simulate(eng, trace, max_new_tokens=2)
    out["simulate"] = sorted((r.rid, r.tokens.tolist(), r.arrival,
                              r.completion, r.ttft) for r in res)
    out["hosted"] = (sorted(srv._hosted_of), len(srv._plan_arrays))
    return out


STEP_PLANS = ("none", "single", "stacked")


def serve_steps(cfg, params, mesh, inp, device="cpu"):
    """``make_prefill_step`` / ``make_decode_step`` under no plan, the
    identity plan of ``make_serve_plan`` and the stacked plan of ``inp``
    (params: the full model; each step gets this rank's fsdp shard): the
    prefill logits, and two decode steps' logits, expert choices and the
    final cache."""
    from repro_torch.convert import shard_params
    from repro_torch.core.serving import PlanArrays
    from repro_torch.launch.sharding import expert_layout
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_serve_plan)
    from repro_torch.models import lm
    tag = "none" if mesh is None else "x".join(map(str, mesh.shape))
    stacked = PlanArrays(*(torch.from_numpy(inp[f"{tag}/stacked/{f}"])
                           for f in PlanArrays._fields))
    plans = {"none": None, "single": make_serve_plan(cfg, mesh, device),
             "stacked": stacked}
    layout = None if mesh is None else \
        expert_layout(mesh, params, "prefill", fsdp=True)
    ps = shard_params(params, mesh, None if layout is None else layout.specs)
    tokens = torch.from_numpy(inp["tokens"])
    out = {"plan": [a.numpy() for a in plans["single"]]}
    with torch.inference_mode():
        for name, plan in plans.items():
            pre = make_prefill_step(cfg, layout, serve_plan=plan)
            dec = make_decode_step(cfg, layout, serve_plan=plan)
            cache = lm.init_cache(cfg, tokens.shape[0], 12,
                                  dtype=torch.float32, device=device)
            steps = []
            for i in range(2):
                logits, cache, experts = dec(ps, cache, tokens[:, i])
                steps.append((logits.numpy(), experts.numpy()))
            out[name] = {"prefill": pre(ps, {"tokens": tokens}).numpy(),
                         "decode": steps, "cache_k": cache.kv.k.numpy()}
    return out


def decode_matches_prefill(cfg, params, mesh, tokens, device="cpu"):
    """Max |prefill's last logits - the logits of decoding the prompt a
    token at a time|, with no plan and under the identity plan."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.sharding import expert_layout
    from repro_torch.launch.steps import make_serve_plan
    from repro_torch.models import lm
    layout = None if mesh is None else expert_layout(mesh, params, "prefill")
    ps = shard_params(params, mesh, None if layout is None else layout.specs)
    out = []
    with torch.inference_mode():
        for plan in (None, make_serve_plan(cfg, mesh, device)):
            want = lm.forward_prefill(cfg, ps, {"tokens": tokens},
                                      layout=layout, serve_plan=plan).logits
            cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                  dtype=torch.float32, device=device)
            for i in range(tokens.shape[1]):
                got, cache, _ = lm.decode_step(cfg, ps, cache, tokens[:, i],
                                               layout=layout, serve_plan=plan)
            out.append(float((got - want).abs().max()))
    return out


def serve_steps_body(rank, params_path, inp_path, shape):
    """``serve_steps`` and ``decode_matches_prefill`` on a mesh of
    ``shape`` (no token dropped: capacity factor 4)."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, device="cpu")
    cfg = _smoke()
    params = params_from_npz(cfg, params_path)
    inp = np.load(inp_path)
    out = serve_steps(cfg, params, mesh, inp)
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    out["decode_vs_prefill"] = decode_matches_prefill(
        roomy, params, mesh, torch.from_numpy(inp["tokens"]))
    return out


def record_config():
    """gpt2-moe-smoke in bf16 at head dim 64: a config whose every kernel
    contract holds on the meta route, for the recorded-collectives test."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gpt2-moe-smoke"),
                               dtype="bfloat16", head_dim=64)


def record_steps_body(rank, shape, train_batch, serve_batch, seq):
    """Rank 0's train step and serve prefill (``launch.dryrun``'s
    programs) on a real gloo mesh, every collective recorded through the
    mesh's methods -> {step: [record tuples]}."""
    from repro_torch.launch.dryrun import step_program
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, device="cpu")
    out = {}
    for kind, b in (("train", train_batch), ("prefill", serve_batch)):
        step, args = step_program(record_config(), kind, b, seq, mesh=mesh,
                                  device="cpu")
        mesh.records = []
        step(*args)
        out[kind] = [tuple(r) for r in mesh.records]
    return out


# ---------------------------------------------------------------------------
# the dense-sharded path (launch.sharding): tests/test_torch_sharding.py and
# tests/test_torch_tp.py
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g)


def mirror_body(rank, mirror):
    """Rank 0's dense-sharded train step (loss and reduced gradients) and
    prefill logits, on ``MirrorMesh`` in one process (``mirror``) or on a
    real gloo mesh whose every rank holds rank 0's shards, batch and
    coordinates; with the collectives each recorded."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import MirrorMesh, RecordingMesh, make_mesh
    from repro_torch.launch.steps import make_serve_plan, make_train_step
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    out = {}
    # the MoE case keeps one `model` rank: after a real all-to-all a rank
    # holds the blocks sent to it, which no longer equal rank 0's, so a
    # real world of equal ranks exists only for an exchange of one
    for arch, shape in (("qwen3-8b-smoke", (2, 2)),
                        ("mixtral-8x22b-smoke", (2, 1, 2))):
        cfg = get_config(arch)
        if cfg.moe.enabled:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=4.0))
        if mirror:
            mesh = MirrorMesh(shape, device="cpu")
        else:
            mesh = make_mesh(shape, device="cpu")
            mesh.coords = {a: 0 for a in mesh.axis_names}
            mesh.records = []
        rank0 = RecordingMesh(shape, mesh.axis_names)
        params = full_params(cfg)
        b, s = 4, 16
        toks = _tokens(cfg, b, s, 1)
        batch = S.local_rows({"tokens": toks, "labels": _tokens(
            cfg, b, s, 2)}, rank0, b)
        res = {}
        lt = S.layout_for(cfg, mesh, params, "train", global_batch=b)
        local = shard_params(params, rank0, specs=lt.specs)
        step = make_train_step(cfg, layout=lt)
        grads, loss, aux, _ = step.reduced_grads(local, batch)
        res["loss"] = loss.numpy()
        for i, g in enumerate(tree_leaves(grads)):
            res[f"grad{i}"] = g.numpy()
        ls = S.layout_for(cfg, mesh, params, "prefill", global_batch=b)
        sp = lm.cast_for_compute(cfg, shard_params(params, rank0,
                                                   specs=ls.specs))
        with torch.no_grad():
            res["logits"] = lm.forward_prefill(
                cfg, sp, {"tokens": batch["tokens"]}, layout=ls,
                serve_plan=make_serve_plan(cfg, mesh, device="cpu")
            ).logits.numpy()
        out[arch] = res
        out[arch + "/records"] = [tuple(r) for r in mesh.records]
    return out


def tp_body(rank, root):
    """The dense-sharded path on gloo ranks against the port with no mesh
    (the test compares the no-mesh side with the reference): per case the
    rank's loss, its gathered reduced gradients and (rank 0) the no-mesh
    gradients; prefill and decode logits over the sequence-sharded cache;
    a trainer saved on (2, 2) (resumed by the test with no mesh)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (global_grad_norm, make_serve_plan,
                                          make_train_step)
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_unflatten_like
    out = {}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, device="cpu")
        return meshes[shape]
    for name, arch, shape, over in TP_CASES:
        cfg = get_config(arch)
        if over:
            cfg = dataclasses.replace(cfg, **over)
        if cfg.moe.enabled:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0, aux_loss_weight=0.0))
        mesh = mesh_of(shape)
        params = full_params(cfg)
        b, s = 4, 16
        batch = {"tokens": _tokens(cfg, b, s, 1),
                 "labels": _tokens(cfg, b, s, 2)}
        lt = S.layout_for(cfg, mesh, params, "train", global_batch=b)
        step = make_train_step(cfg, layout=lt)
        local = shard_params(params, mesh, specs=lt.specs)
        grads, loss, _, _ = step.reduced_grads(
            local, S.local_rows(batch, mesh, b))
        norm = global_grad_norm(mesh, grads, specs=lt.specs)
        full = unshard_params(grads, mesh, specs=lt.specs)
        res = {"loss": float(loss), "norm": float(norm)}
        if rank == 0:
            res["grads"] = [g.numpy() for g in tree_leaves(full)]
            ps = [p.detach().requires_grad_() for p in tree_leaves(params)]
            want = lm.forward_train(cfg, tree_unflatten_like(params, ps),
                                    batch)
            res["want_loss"] = float(want.loss)
            res["want"] = [g.numpy() for g in torch.autograd.grad(
                want.loss, ps, allow_unused=True, materialize_grads=True)]
        # prefill and DECODE_STEPS decode steps over a cache of
        # DECODE_SLOTS slots (its sequence split): past the first rank's
        # slice, and round the ring of a sliding window
        ls = S.layout_for(cfg, mesh, params, "prefill", global_batch=b)
        sp = shard_params(params, mesh, specs=ls.specs)
        plan = make_serve_plan(cfg, mesh, device="cpu")
        with torch.no_grad():
            pre = lm.forward_prefill(cfg, sp, S.local_rows(
                {"tokens": batch["tokens"]}, mesh, b), layout=ls,
                serve_plan=plan)
            cache = lm.init_cache(cfg, b, DECODE_SLOTS, torch.float32,
                                  device="cpu")
            ld = S.layout_for(cfg, mesh, params, "decode", global_batch=b,
                              cache=cache)
            lc = shard_params(cache, mesh, specs=ld.cache_specs)
            steps = []
            for t in range(DECODE_STEPS):
                logits, lc, _ = lm.decode_step(
                    cfg, sp, lc, S.local_rows(batch["tokens"][:, t], mesh,
                                              b), layout=ld,
                    serve_plan=plan)
                steps.append(logits.numpy())
        res["prefill"] = pre.logits.numpy()
        res["decode"] = steps
        res["cache_shape"] = tuple(lc.kv.k.shape)
        res["rows"] = S.local_rows(torch.arange(b), mesh, b).tolist()
        out[name] = res
    # a trainer saved on (2, 2), dense-sharded
    from repro_torch.tree import tree_items
    tr = _trainer(get_config("qwen3-8b-smoke"), root, mesh_of((2, 2)),
                  schedule="priority+partition", partition_bytes=4096)
    state = tr.run()
    full = tr._gather(state)
    out["trainer"] = {"losses": [r["loss"] for r in tr.metrics_log],
                      "state": {k: v.numpy() for k, v in
                                tree_items(full)} if rank == 0 else None}
    return out


# decode: 6 steps over 8 slots write 2 ranks' slices on (2, 2) (4 slots a
# rank) and 3 on mixtral's (1, 2, 2) (2 a rank); the window of 4 keeps 4
# slots, 2 a rank, and its ring wraps from rank 1's slice to rank 0's
DECODE_STEPS = 6
DECODE_SLOTS = 8
# (name, arch, mesh, config overrides): GQA, MQA, heads that do not split,
# a sliding window, Mixtral's expert slicing on (data, model, tp)
TP_CASES = (
    ("gqa", "qwen3-8b-smoke", (2, 2), {"n_kv_heads": 2}),
    ("mqa", "granite-34b-smoke", (2, 2), None),
    ("odd_heads", "qwen3-8b-smoke", (2, 2), {"n_heads": 3,
                                             "n_kv_heads": 1}),
    ("window", "qwen3-8b-smoke", (2, 2), {"n_kv_heads": 2,
                                          "sliding_window": 4}),
    ("mixtral", "mixtral-8x22b-smoke", (1, 2, 2), None),
)


# ---------------------------------------------------------------------------
# Megatron sequence parallelism (cfg.seq_parallel): tests/test_torch_sp.py
# ---------------------------------------------------------------------------

def sp_config(get_config, arch, over):
    """``arch`` from ``get_config`` (the port's or the reference's) with a
    case's overrides (a "moe" entry holds the MoE config's) and the MoE
    cases' capacity 8 and no aux loss."""
    import dataclasses
    cfg = get_config(arch)
    over = dict(over or {})
    moe = over.pop("moe", {})
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_weight=0.0, **moe))
    return cfg


def sp_batch(cfg, b, s):
    """A train batch of ``s`` positions: tokens and next-token labels, the
    vision stub's patches ahead of s - P tokens, the audio stub's frames
    (float32, seeded)."""
    from repro_torch.models.lm import FRAME_DIM
    if cfg.frontend == "audio_stub":
        g = torch.Generator().manual_seed(4)
        return {"frames": torch.randn((b, s, FRAME_DIM), generator=g),
                "labels": _tokens(cfg, b, s, 2)}
    st = s - cfg.n_patches if cfg.frontend == "vision_stub" else s
    out = {"tokens": _tokens(cfg, b, st, 1), "labels": _tokens(cfg, b, st, 2)}
    if cfg.frontend == "vision_stub":
        g = torch.Generator().manual_seed(3)
        out["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                     generator=g)
    return out


def _sp_run(cfg, mesh, params, batch, sp: bool):
    """One case's results with ``cfg.seq_parallel`` = ``sp``: the rank's
    loss, the reduced gradients gathered whole, the global norm and the
    prefill logits; the records of the train step and of the prefill."""
    import dataclasses
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import (global_grad_norm, make_serve_plan,
                                          make_train_step)
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(cfg, seq_parallel=sp)
    b = batch["labels"].shape[0]
    rows = S.local_rows(batch, mesh, b)
    lt = S.layout_for(cfg, mesh, params, "train", global_batch=b)
    step = make_train_step(cfg, layout=lt)
    local = shard_params(params, mesh, specs=lt.specs)
    mesh.records = []
    g, loss, _, _ = step.reduced_grads(local, rows)
    res = {"train_records": [tuple(r) for r in mesh.records]}
    mesh.records = None
    res["norm"] = float(global_grad_norm(mesh, g, specs=lt.specs))
    res["loss"] = float(loss)
    res["grads"] = [t.numpy() for t in tree_leaves(
        unshard_params(g, mesh, specs=lt.specs))]
    ls = S.layout_for(cfg, mesh, params, "prefill", global_batch=b)
    sp_params = shard_params(params, mesh, specs=ls.specs)
    mesh.records = []
    with torch.no_grad():
        res["prefill"] = lm.forward_prefill(
            cfg, sp_params, {k: v for k, v in rows.items() if k != "labels"},
            layout=ls, serve_plan=make_serve_plan(cfg, mesh, device="cpu")
        ).logits.numpy()
    res["prefill_records"] = [tuple(r) for r in mesh.records]
    mesh.records = None
    res["rows"] = S.local_rows(torch.arange(b), mesh, b).tolist()
    return res


def _dropped_gather(ctx, g):
    """A mutant backward of the reduce-scatter: the local adjoint of a
    slice (this rank's block of the gradient, zeros elsewhere), its
    all-gather dropped."""
    full = torch.zeros(*g.shape[:ctx.dim],
                       g.shape[ctx.dim] * ctx.mesh.group_size(ctx.group),
                       *g.shape[ctx.dim + 1:], dtype=g.dtype)
    i = ctx.mesh.group_index(ctx.group)
    full.narrow(ctx.dim, i * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
    return full, None, None, None


def sp_body(rank):
    """Megatron-SP on gloo ranks: per case of SP_CASES the results of
    ``_sp_run`` with the flag on and off, and (rank 0) the no-mesh loss
    and gradients; a sequence that does not tile the group (S = 15); the
    hybrid and RWKV stacks with the flag on and off; the dry run's decode
    variants (DECODE_VARIANTS) against the no-mesh step; and the gqa case
    with the reduce-scatter's backward all-gather dropped (a mutation)."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_unflatten_like
    out = {}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, device="cpu")
        return meshes[shape]
    b, s = SP_BATCH
    for name, arch, shape, over in SP_CASES:
        cfg = sp_config(get_config, arch, over)
        mesh = mesh_of(shape)
        params = full_params(cfg)
        batch = sp_batch(cfg, b, s)
        res = {"on": _sp_run(cfg, mesh, params, batch, True),
               "off": _sp_run(cfg, mesh, params, batch, False)}
        if rank == 0:
            ps = [p.detach().requires_grad_() for p in tree_leaves(params)]
            want = lm.forward_train(cfg, tree_unflatten_like(params, ps),
                                    batch)
            res["want_loss"] = float(want.loss)
            res["want"] = [g.numpy() for g in torch.autograd.grad(
                want.loss, ps, allow_unused=True, materialize_grads=True)]
        out[name] = res
    _, arch, shape, over = SP_CASES[0]
    gqa = sp_config(get_config, arch, over)
    mesh = mesh_of(shape)
    params = full_params(gqa)
    out["untiled"] = {sp: _sp_run(gqa, mesh, params, sp_batch(gqa, b, 15),
                                  sp) for sp in (True, False)}
    for arch in ("zamba2-1.2b-smoke", "rwkv6-1.6b-smoke"):
        cfg = get_config(arch)
        stack = full_params(cfg)
        out[arch] = {sp: _sp_run(cfg, mesh, stack, sp_batch(cfg, 2, s), sp)
                     for sp in (True, False)}
    for name, shape, split, over in DECODE_VARIANTS:
        cfg = sp_config(get_config, "qwen3-8b-smoke", over)
        dmesh = mesh_of(shape)
        dparams = full_params(cfg)
        got, local = decode_variant(cfg, dmesh, dparams, split)
        res = {"logits": got, "cache_shape": local,
               "rows": S.local_rows(torch.arange(4), dmesh, 4).tolist(),
               "coords": dict(dmesh.coords)}
        if rank == 0:
            res["want"] = decode_variant(cfg, None, dparams, split)[0]
        out[name] = res
    keep = collectives._ReduceScatter.backward
    collectives._ReduceScatter.backward = staticmethod(_dropped_gather)
    try:
        out["mutant"] = _sp_run(gqa, mesh, params, sp_batch(gqa, b, s), True)
    finally:
        collectives._ReduceScatter.backward = keep
    return out


SP_BATCH = (4, 16)          # rows, positions
# (name, arch, mesh, config overrides): TP_CASES, the gqa case under
# remat (the carry's slices saved at each group boundary, the group's
# gathers and scatters recomputed in the backward) and without tensor
# parallelism (every weight whole after its FSDP gather: the carry still
# split, each layer's whole output cut to the slice), llama4's shared
# expert beside its MoE layers (every other block), the ScMoE shortcut
# fused into the layer (gpt2-moe; mixtral's, whose `tp` sum is deferred
# to a reduce-scatter, cut to the slice), and the two frontends (llava's
# 8 patches ahead of 8 tokens; hubert's frames, a bidirectional encoder)
SP_CASES = TP_CASES + (
    ("remat", "qwen3-8b-smoke", (2, 2), {"n_kv_heads": 2, "remat": True}),
    ("dp_only", "qwen3-8b-smoke", (2, 2), {"n_kv_heads": 2,
                                           "tensor_parallel": False}),
    ("shared_expert", "llama4-maverick-400b-a17b-smoke", (2, 2), None),
    ("shortcut", "gpt2-moe-smoke", (2, 2), {"moe": {"shortcut": True}}),
    ("tp_shortcut", "mixtral-8x22b-smoke", (1, 2, 2),
     {"moe": {"shortcut": True}}),
    ("vision", "llava-next-34b-smoke", (2, 2), None),
    ("audio", "hubert-xlarge-smoke", (2, 2), None),
)
# the dry run's decode variants on gloo ranks: (name, mesh, cache split,
# config overrides); kv_split's (1, 2, 2) is `model` = the 2 kv heads,
# `tp` = 2 (the ring of a window of 4 wraps across the `tp` ranks)
DECODE_VARIANTS = (
    ("kv_split", (1, 2, 2), "kv", {"n_kv_heads": 2}),
    ("kv_split_window", (1, 2, 2), "kv", {"n_kv_heads": 2,
                                          "sliding_window": 4}),
    ("cache_batch_only", (2, 2), "batch", {"n_kv_heads": 2}),
)


def decode_variant(cfg, mesh, params, split, b=4):
    """DECODE_STEPS decode steps from an empty cache of DECODE_SLOTS
    slots placed by ``cache_specs``' ``split`` (no mesh: the plain step)
    -> (this rank's rows' logits a step, its local cache shape)."""
    from repro_torch.convert import shard_params
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm
    toks = _tokens(cfg, b, DECODE_STEPS, 1)
    cache = lm.init_cache(cfg, b, DECODE_SLOTS, torch.float32, device="cpu")
    layout, p, rows = None, params, toks
    if mesh is not None:
        layout = S.layout_for(cfg, mesh, params, "decode", global_batch=b,
                              cache=cache, cache_split=split)
        p = shard_params(params, mesh, specs=layout.specs)
        cache = shard_params(cache, mesh, specs=layout.cache_specs)
        rows = S.local_rows(toks, mesh, b)
    out = []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            logits, cache, _ = lm.decode_step(cfg, p, cache, rows[:, t],
                                              layout=layout)
            out.append(logits.numpy())
    return out, tuple(cache.kv.k.shape)


# ---------------------------------------------------------------------------
# wall-clock serving on a mesh (runtime.engine's request router):
# tests/test_torch_serve_wallclock.py
# ---------------------------------------------------------------------------

WALL_PROMPTS = (5, 9, 3, 12, 7)     # prompt lengths
WALL_NEW = 3                        # tokens each generates


def wallclock_body(rank, shape):
    """gpt2-moe-smoke's ``MoEServer`` on ``shape``: rank 0 submits
    WALL_PROMPTS and every rank calls ``run()``; rank 0 then submits a
    follow-up of request 0 and every rank runs again; a second engine
    replays the first requests through ``simulate``; another rank's
    wall-clock submit is refused.  -> the results, the records of the
    first run, the follow-up's path state, the refusal's message."""
    import numpy as np
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                            simulate)
    from repro_torch.runtime.server import MoEServer, profile_from_training
    mesh = make_mesh(shape, device="cpu")
    cfg = _smoke()
    params = full_params(cfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(2)), mesh=mesh)
    srv = MoEServer(cfg, params, prof, mesh=mesh)
    g = np.random.default_rng(3)
    prompts = [g.integers(0, cfg.vocab_size, n) for n in WALL_PROMPTS]
    ecfg = EngineConfig(max_batch_tokens=24, max_batch_requests=2)

    def rows(res):
        return sorted((r.rid, r.n_tokens, r.tokens.tolist(), r.arrival,
                       r.completion, r.ttft, r.logits.tolist())
                      for r in res)
    out = {}
    with torch.inference_mode():
        eng = ServingEngine(srv, ecfg)
        if rank == 0:
            for p in prompts:
                eng.submit(p, max_new_tokens=WALL_NEW)
        else:
            try:
                eng.submit(prompts[0])
            except RuntimeError as e:
                out["refused"] = str(e)
        mesh.records = []
        out["wall"] = rows(eng.run())
        out["kinds"] = sorted({(r.kind, r.axis) for r in mesh.records})
        mesh.records = None
        out["steps"] = eng.step_idx
        if rank == 0:
            eng.submit(prompts[1], prev_rid=0, max_new_tokens=1)
        out["follow_up"] = rows(eng.run())
        out["path_state"] = eng.request_path_state(len(prompts)).tolist()
        res = simulate(ServingEngine(srv, ecfg),
                       [(p, 0.0) for p in prompts], max_new_tokens=WALL_NEW)
        out["replay"] = sorted((r.rid, r.tokens.tolist(), r.logits.tolist())
                               for r in res)
    return out


def wallclock_stamp_body(rank, shape):
    """gpt2-moe-smoke served in wall-clock mode on ``shape`` with an
    engine clock that counts its calls (each reading one more than the
    last) -> per step, the completion stamps of its results and the
    clock's last reading when the step returned."""
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    from repro_torch.runtime.server import MoEServer, profile_from_training
    from repro_torch.data import DataConfig, SyntheticLM
    mesh = make_mesh(shape, device="cpu")
    cfg = _smoke()
    params = full_params(cfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4, seed=0))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(2)), mesh=mesh)
    srv = MoEServer(cfg, params, prof, mesh=mesh)
    readings = []

    def clock():
        readings.append(float(len(readings)))
        return readings[-1]
    g = np.random.default_rng(3)
    steps = []
    with torch.inference_mode():
        eng = ServingEngine(srv, EngineConfig(max_batch_tokens=24,
                                              max_batch_requests=2),
                            clock=clock)
        for n in WALL_PROMPTS:
            eng.submit(g.integers(0, cfg.vocab_size, n),
                       max_new_tokens=WALL_NEW)
        while eng.has_work():
            out = eng.step()
            steps.append(([(r.completion, r.ttft) for r in out],
                          readings[-1]))
    return steps
