"""The train step of the port: forward, backward, Lina's gradient
reduction and the AdamW update on this rank (the reference's
``launch/steps.py::make_train_step``).

Without a ``layout`` it is the single-rank step: no all-to-all, and with
no schedule no reduction.  With one (``launch.sharding.Layout``: a mesh,
the spec tree its params are stored by and the axes its batch rows are
split over) the entry points compute with this rank's shards
(``models.lm``) and the gradients are reduced over the ranks by each
leaf's spec (``optim.reduce``): ``schedule`` None is one unordered
all-reduce a group (the DDP default, the reference's implicit reduction),
the named schedules are Lina's.  The global gradient norm sums each
leaf's square over the axes it is split on, and the loss and aux metrics
are averaged over the world, so every rank logs the global step.

The step's ranges (``obs.region``): ``optim.reduce`` around each
gradient reduction, ``optim.update`` around the clip and AdamW; the
forward's are ``models.lm``'s.

``make_prefill_step``, ``make_decode_step`` and ``make_serve_plan`` are the
reference's serve steps: ``models.lm``'s serve entry points over a layout
(or none), under an identity plan sized to the mesh's expert-parallel
group.  Their ``params`` are this rank's (``convert.shard_params``), and
each call fetches the hosted experts' weights anew, as the reference's
does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.placement import identity_plan
from repro_torch.core.serving import PlanArrays
from repro_torch.launch.mesh import ep_size
from repro_torch.models import lm as lm_mod
from repro_torch.obs import region
from repro_torch.optim import reduce as reduce_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def global_grad_norm(mesh, grads, specs) -> torch.Tensor:
    """The norm of the whole model's reduced gradient, from this rank's
    leaves: each leaf's square summed over the axes its spec in ``specs``
    splits it on (one all-reduce of a vector a set of axes), never over
    its replicas, then added in leaf order, as
    ``adamw.clip_by_global_norm`` adds them (so one rank gives its norm
    bit for bit)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    by = {}                    # the axes -> the leaves summed over them
    for i, s in enumerate(tree_leaves(specs)):
        names = tuple(a for a in mesh.axis_names if a in s.names())
        if names:
            by.setdefault(names, []).append(i)
    for names, idx in by.items():
        v = torch.stack([sq[i] for i in idx])
        mesh.all_reduce(v, mesh.group_for(names))
        for j, i in enumerate(idx):
            sq[i] = v[j]
    return torch.sqrt(sum(sq))


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, *,
                    layout=None, lina: bool = True,
                    dispatch_backend: str = "scatter",
                    microbatches: int = 1,
                    schedule: Optional[str] = None,
                    partition_bytes: float =
                    reduce_mod.DEFAULT_PARTITION_BYTES,
                    grad_compression: Optional[str] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` are this rank's fp32 master ``LMParams`` (its shards by
    ``layout.specs``, ``convert.shard_params``; the AdamW moments alike);
    ``batch`` holds this rank's ``tokens`` and ``labels`` [B, S] on its
    device.  ``microbatches > 1``
    sums the gradients of B / microbatches slices, then divides, as the
    reference's scan.  ``metrics`` holds 0-d tensors ``loss``,
    ``aux_loss``, ``grad_norm`` and ``lr``.

    ``schedule`` (``optim.reduce.SCHEDULES``) reduces the gradients after
    the backward all-to-all; with ``priority+partition+pipeline`` and
    ``microbatches > 1`` microbatch i's chunked reduce is issued async
    before microbatch i+1's forward and backward, and every one is waited
    for before AdamW.  ``grad_compression`` ("bf16" | "int8_ef") needs a
    schedule; int8 error feedback is stateful, which makes the step
    (params, opt_state, batch, reduce_state) ->
    (params, opt_state, metrics, reduce_state).

    The returned step's ``reduced_grads(params, batch, reduce_state)``
    gives (grads, loss, aux, reduce_state) without the update."""
    mesh = specs = None
    if layout is not None:
        mesh, specs = layout.mesh, layout.specs
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    if grad_compression is not None and schedule is None:
        raise ValueError("grad_compression requires an explicit schedule "
                         f"(one of {reduce_mod.SCHEDULES})")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    rcfg = None
    if schedule is not None:
        rcfg = reduce_mod.ReduceConfig(schedule=schedule,
                                       partition_bytes=partition_bytes,
                                       compression=grad_compression)
    elif mesh is not None:
        rcfg = reduce_mod.ReduceConfig(schedule="baseline")
    stateful = grad_compression == "int8_ef"
    pipelined = (rcfg is not None and microbatches > 1 and
                 schedule == "priority+partition+pipeline")

    def grads_of(params, batch):
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        out = lm_mod.forward_train(cfg, ps, batch,
                                   dispatch_backend=dispatch_backend,
                                   lina=lina, layout=layout)
        # a leaf the loss does not reach (hubert's token embedding: it
        # reads frames) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(out.loss, tree_leaves(ps),
                                    allow_unused=True, materialize_grads=True)
        return (tree_unflatten_like(params, grads), out.loss.detach(),
                out.aux_loss.detach())

    def reduce(grads, rstate, async_op=False):
        with region("optim.reduce"):
            after = reduce_mod.backward_a2a_token(mesh)
            return reduce_mod.reduce_gradients(mesh, grads, rcfg,
                                               after=after, state=rstate,
                                               async_op=async_op,
                                               specs=specs)

    def reduced_grads(params, batch, rstate=None):
        if microbatches == 1:
            grads, loss, aux = grads_of(params, batch)
            if rcfg is not None:
                grads, rstate = reduce(grads, rstate)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            grads = loss = aux = None
            pending = []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, l, a = grads_of(params, mb)
                if pipelined:
                    # this microbatch's chunks go out now and run beside
                    # the next microbatch's forward and backward
                    p, rstate = reduce(g, rstate, async_op=True)
                    pending.append(p)
                    g = None
                if loss is None:
                    loss, aux = l, a
                else:
                    loss, aux = loss + l, aux + a
                if g is not None:
                    grads = g if grads is None else \
                        tree_map(torch.add, grads, g)
            for p in pending:
                g = p.wait()
                grads = g if grads is None else tree_map(torch.add, grads, g)
            if rcfg is not None and not pipelined:
                grads, rstate = reduce(grads, rstate)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss, aux = loss / microbatches, aux / microbatches
        if mesh is not None:
            lv = torch.stack([loss.float(), aux.float()])
            mesh.all_reduce(lv, mesh.world_group)
            loss, aux = (lv / mesh.world).unbind()
        return grads, loss, aux, rstate

    def finish(params, opt_state, grads, loss, aux):
        with region("optim.update"):
            gn = None if mesh is None else global_grad_norm(mesh, grads,
                                                            specs)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt_cfg, grad_norm=gn)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    if stateful:
        def train_step(params, opt_state, batch, reduce_state):
            grads, loss, aux, reduce_state = reduced_grads(params, batch,
                                                           reduce_state)
            return (*finish(params, opt_state, grads, loss, aux),
                    reduce_state)
    else:
        def train_step(params, opt_state, batch):
            grads, loss, aux, _ = reduced_grads(params, batch)
            return finish(params, opt_state, grads, loss, aux)

    train_step.reduced_grads = reduced_grads
    return train_step


def make_prefill_step(cfg, layout=None, *, serve_plan=None,
                      serve_top_k=None):
    """(params, batch) -> last-position logits [B, V]
    (``lm.forward_prefill`` over ``layout``)."""
    def prefill_step(params, batch):
        return lm_mod.forward_prefill(cfg, params, batch,
                                      serve_plan=serve_plan,
                                      serve_top_k=serve_top_k,
                                      layout=layout).logits
    return prefill_step


def make_decode_step(cfg, layout=None, *, serve_plan=None,
                     serve_top_k=None):
    """(params, cache, token) -> (logits, cache, expert_choices)
    (``lm.decode_step`` over ``layout``)."""
    def decode_step(params, cache, token):
        return lm_mod.decode_step(cfg, params, cache, token,
                                  serve_plan=serve_plan,
                                  serve_top_k=serve_top_k, layout=layout)
    return decode_step


def make_serve_plan(cfg, mesh, device="cuda") -> Optional[PlanArrays]:
    """Identity plan sized to the mesh's expert-parallel group (popularity
    plans replace it at run time through the server), on the mesh's
    device (else ``device``, the card by default); None for a dense
    config or experts that do not split over the group."""
    if not cfg.moe.enabled:
        return None
    ep = ep_size(mesh)
    if cfg.moe.n_experts % ep:
        return None
    pack = max(1, cfg.moe.n_experts // ep)
    return PlanArrays.from_plan(
        identity_plan(cfg.moe.n_experts, ep, max_pack=max(pack, 2)),
        device=mesh.device if mesh is not None else device)
