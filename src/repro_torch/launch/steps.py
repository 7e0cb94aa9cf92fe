"""The train step of the port: forward, backward, Lina's gradient
reduction and the AdamW update on this rank (the reference's
``launch/steps.py::make_train_step``).

Without a mesh it is the single-rank step: no all-to-all, and with no
schedule no reduction.  With a mesh (``launch.mesh``) the MoE layers run
expert parallel over its `model` group and the gradients are reduced over
the ranks (``optim.reduce``): ``schedule`` None is one unordered
all-reduce (the DDP default, the reference's implicit reduction), the
named schedules are Lina's.  The global gradient norm adds the squares of
the expert shards over the `model` group (over the world with ``fsdp``),
and the loss and aux metrics are averaged over the world, so every rank
logs the global step.

``make_prefill_step``, ``make_decode_step`` and ``make_serve_plan`` are the
reference's serve steps: the transformer branch of ``models.lm``'s serve
entry points on a mesh (or none), under an identity plan sized to the
mesh's expert-parallel group.  Their ``params`` are this rank's
(``convert.shard_params``, with ``fsdp`` also cut over `data`), and each
call fetches the hosted experts' weights anew, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.moe import expert_leaf_flags
from repro_torch.core import axes
from repro_torch.core.placement import identity_plan
from repro_torch.core.serving import PlanArrays
from repro_torch.launch.mesh import ep_size
from repro_torch.models import lm as lm_mod
from repro_torch.optim import reduce as reduce_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def global_grad_norm(mesh, grads, fsdp: bool = False) -> torch.Tensor:
    """The norm of the whole model's reduced gradient, from this rank's
    leaves: replicated leaves once, each expert leaf's square summed over
    the ranks that hold the other experts (one all-reduce of a vector),
    then added in leaf order, as ``adamw.clip_by_global_norm`` adds them
    (so one rank gives its norm bit for bit)."""
    flags = expert_leaf_flags(grads)
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    exp = [i for i, f in enumerate(flags) if f]
    if exp:
        v = torch.stack([sq[i] for i in exp])
        mesh.all_reduce(v, mesh.world_group if fsdp
                        else mesh.group(axes.EP_AXIS))
        for j, i in enumerate(exp):
            sq[i] = v[j]
    return torch.sqrt(sum(sq))


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, *,
                    mesh=None, lina: bool = True, fsdp: bool = False,
                    dispatch_backend: str = "scatter",
                    microbatches: int = 1,
                    schedule: Optional[str] = None,
                    partition_bytes: float =
                    reduce_mod.DEFAULT_PARTITION_BYTES,
                    grad_compression: Optional[str] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` are this rank's fp32 master ``LMParams`` (its expert shard
    with a mesh, ``convert.shard_params``); ``batch`` holds this rank's
    ``tokens`` and ``labels`` [B, S] on its device.  ``microbatches > 1``
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
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    if grad_compression is not None and schedule is None:
        raise ValueError("grad_compression requires an explicit schedule "
                         f"(one of {reduce_mod.SCHEDULES})")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if fsdp and mesh is None:
        raise ValueError("fsdp needs a mesh")
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
                                   mesh=mesh, lina=lina, fsdp=fsdp)
        # a leaf the loss does not reach (hubert's token embedding: it
        # reads frames) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(out.loss, tree_leaves(ps),
                                    allow_unused=True, materialize_grads=True)
        return (tree_unflatten_like(params, grads), out.loss.detach(),
                out.aux_loss.detach())

    def reduce(grads, rstate, async_op=False):
        after = reduce_mod.backward_a2a_token(mesh)
        return reduce_mod.reduce_gradients(mesh, grads, rcfg, after=after,
                                           state=rstate, fsdp=fsdp,
                                           async_op=async_op)

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
        gn = None if mesh is None else global_grad_norm(mesh, grads, fsdp)
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


def make_prefill_step(cfg, mesh, *, serve_plan=None, serve_top_k=None,
                      fsdp: bool = True):
    """(params, batch) -> last-position logits [B, V]
    (``lm.forward_prefill``)."""
    def prefill_step(params, batch):
        return lm_mod.forward_prefill(cfg, params, batch, mesh=mesh,
                                      serve_plan=serve_plan,
                                      serve_top_k=serve_top_k,
                                      fsdp=fsdp).logits
    return prefill_step


def make_decode_step(cfg, mesh, *, serve_plan=None, serve_top_k=None,
                     fsdp: bool = True):
    """(params, cache, token) -> (logits, cache, expert_choices)
    (``lm.decode_step``)."""
    def decode_step(params, cache, token):
        return lm_mod.decode_step(cfg, params, cache, token, mesh=mesh,
                                  serve_plan=serve_plan,
                                  serve_top_k=serve_top_k, fsdp=fsdp)
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
