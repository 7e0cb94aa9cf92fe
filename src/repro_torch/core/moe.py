"""The MoE layer: gating -> dispatch -> (a2a micro-ops pipelined with the
grouped expert FFN) -> combine (paper Fig. 1), in PyTorch; the reference's
``_moe_shard_body`` / ``moe_layer`` (``src/repro/core/moe.py``) on one
rank's token shard.

With a ``mesh`` (``launch.mesh``) the experts are sharded over its `model`
group (each rank holds E / ep of them) and the layer runs Lina's schedule
(``core.microop``): the capacity buffers go to the experts' owners in
``cfg.n_microops`` uniform all-to-all micro-ops, chunk k's FFN runs while
chunk k+1 is in flight, and the results come back the same way.  Without
a mesh it is the single-rank layer: no exchange exists to partition, so
the buffers go to the FFN kernel in one piece with the kept counts (the
reference chunks even on its one-device default mesh).  It is
differentiable on both routes: the kernel route's ops are
``torch.autograd.Function``s whose backward launches kernels too
(``kernels.ops``), and the exchanges' backward is the inverse exchange.
Inside an ``obs.counting()`` block the layer counts the (token, choice)
pairs it routed and kept (``moe.routed_pairs``, ``moe.kept_pairs``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import axes
from repro_torch.core import dispatch as D
from repro_torch.core import microop
from repro_torch.core.collectives import (all_reduce_grad, gather_grad,
                                          reduce_scatter_grad)
from repro_torch.core.gating import (capacity, kept_counts,
                                     router_top_k_gating)
from repro_torch.kernels.moe_ffn import grouped_matmul
from repro_torch.kernels.ops import (ffn_dgrad, ffn_wgrad, grouped_ffn_op,
                                     resolve_backend)
from repro_torch.kernels.ref import gelu
from repro_torch.obs import counters


class MoEParams(NamedTuple):
    router: torch.Tensor            # [d, E]
    wi: torch.Tensor                # [E, d, f]   (gate proj for swiglu)
    wu: Optional[torch.Tensor]      # [E, d, f]   (up proj; None for gelu)
    wo: torch.Tensor                # [E, f, d]


EXPERT_FIELDS = ("wi", "wu", "wo")      # MoEParams leaves sharded over ep


class MoEOutput(NamedTuple):
    y: torch.Tensor                 # [B, S, d]
    aux_loss: torch.Tensor          # scalar
    expert_idx: torch.Tensor        # [T, k] — for popularity profiling
    router_probs: torch.Tensor      # [T, E]
    # the reference's a2a_token has no counterpart here: the mesh records
    # its newest all-to-all as a CUDA event (``Mesh.a2a_event``)


def gather_hidden(w, mesh, dim: int):
    """``w``'s hidden-dim shards (dim ``dim``) gathered over the mesh's
    data-parallel group (FSDP for experts; the backward reduce-scatters
    the gradient)."""
    return gather_grad(w, mesh, mesh.dp_group, dim)


def world_mean_value(v: torch.Tensor, mesh) -> torch.Tensor:
    """``v`` with the value of its mean over every rank of ``mesh`` and
    the gradient of ``v`` itself: each rank's loss then carries the global
    mean's value, and averaging the ranks' gradients (``optim.reduce``)
    gives the gradient of that mean."""
    m = v.detach().clone()
    mesh.all_reduce(m, mesh.world_group)
    return v + (m / mesh.world - v.detach())


def expert_ffn(wi, wu, wo, x, ffn_type: str = "swiglu",
               compute_backend: str = "xla", *, group_expert=None,
               group_rows=None):
    """x: [E_rows, n, d] with per-row expert weights [E_rows, d, f].
    ``"pallas"`` runs the grouped-FFN kernel route; ``"xla"`` the einsum
    formulation it is held against.  The kernel route also takes
    ``group_expert`` (weights [E, d, f] read in place, row g using expert
    group_expert[g]) and ``group_rows`` (rows past each count are zeros);
    the plain route takes neither."""
    if compute_backend == "pallas":
        return grouped_ffn_op(x, wi, wu, wo, ffn_type,
                              group_expert=group_expert,
                              group_rows=group_rows)
    h = torch.einsum("end,edf->enf", x, wi)
    if ffn_type == "swiglu":
        h = F.silu(h) * torch.einsum("end,edf->enf", x, wu)
    else:
        h = gelu(h)
    return torch.einsum("enf,efd->end", h, wo)


class _Plan:
    """What ``_ExpertParallel`` needs besides tensors."""

    def __init__(self, mesh, n_experts, n_chunks, pipeline, ffn_type,
                 backend, counts, shadow):
        self.mesh, self.e, self.n_chunks = mesh, n_experts, n_chunks
        self.pipeline, self.ffn_type, self.backend = pipeline, ffn_type, \
            backend
        self.counts, self.shadow, self.side = counts, shadow, None
        self.ep = mesh.size(axes.EP_AXIS)

    def to_rows(self, recv):
        """[ep * E_local, c, d] received -> the FFN's [E_local, ep * c, d]
        (rows ordered by source rank, then capacity)."""
        c, d = recv.shape[1], recv.shape[2]
        rs = recv.reshape(self.ep, self.e // self.ep, c, d).transpose(0, 1)
        return rs.reshape(self.e // self.ep, self.ep * c, d)

    def from_rows(self, rows, c):
        d = rows.shape[2]
        out = rows.reshape(self.e // self.ep, self.ep, c, d).transpose(0, 1)
        return out.reshape(self.e, c, d)


class _ExpertParallel(torch.autograd.Function):
    """The layer's expert-parallel section as one autograd node: dispatch
    all-to-all micro-ops, the experts' FFN on each landed chunk, return
    all-to-all micro-ops.

    The forward is Lina's pipeline (``microop.pipelined_expert_ffn``), and
    so is the backward, on dy: while dy's first chunk is in flight it
    recomputes h (and u) over the whole saved buffer; chunk k's row-local
    backward (``ffn_dgrad``: dx and the rows' act, dh, du) runs while
    chunk k+1's dy is in flight, and its dx goes back right behind it;
    the weight gradients (``ffn_wgrad``) run once the last dx is issued,
    before any is waited for.  They split the backward by data
    dependence, not by chunk: each expert weight's gradient is one fp32
    sum over every row, rounded once to the weight's dtype, as without a
    mesh (autograd over the chunks would round each chunk's part to the
    bf16 compute dtype and add them there), and a row's dx is the row's
    own.  At ep 1 the whole buffer is the single-rank layer's, so its
    gradients are bitwise that layer's.  The ScMoE shortcut
    (``plan.shadow``) runs, with autograd, while the first dispatch is in
    flight; its output comes back in ``plan.side``.  Where the experts'
    hidden dims are this rank's `tp` slice the output is this rank's
    partial sum, which ``moe_layer`` sums over `tp` after the combine."""

    @staticmethod
    def forward(ctx, buf, wi, wu, wo, plan):
        rows = []

        def ffn(recv, start):
            rs = plan.to_rows(recv)
            c = recv.shape[1]
            gr = None if plan.counts is None else \
                torch.clamp(plan.counts - start, 0, c).to(torch.int32)
            rows.append(rs)
            out = expert_ffn(wi, wu, wo, rs, plan.ffn_type, plan.backend,
                             group_rows=gr)
            return plan.from_rows(out, c)

        def shadow():
            with torch.enable_grad():
                return plan.shadow()

        out, plan.side, _ = microop.pipelined_expert_ffn(
            buf, ffn, plan.mesh, plan.n_chunks, plan.e,
            pipeline=plan.pipeline,
            shadow=shadow if plan.shadow is not None else None)
        ctx.plan, ctx.n = plan, len(rows)
        ctx.save_for_backward(torch.cat(rows, 1) if len(rows) > 1
                              else rows[0], wi, wu, wo)
        return out

    @staticmethod
    def backward(ctx, dy):
        x_rows, wi, wu, wo = ctx.saved_tensors
        plan = ctx.plan
        # the kernel route's products are the reference VJP's (fp32); the
        # plain route's are the operands' dtype, as autograd's
        kernel = plan.backend == "pallas"
        mm = grouped_matmul if kernel else torch.matmul
        hu = {}
        kept = {"dy": [], "act": [], "dh": [], "du": []}

        def recompute():
            hu["h"] = mm(x_rows, wi)
            hu["u"] = mm(x_rows, wu) if wu is not None else None

        def dgrad(recv, start):
            d = plan.to_rows(recv)
            d = d.float() if kernel else d
            rows = slice(plan.ep * start, plan.ep * start + d.shape[1])
            dx, act, dh, du = ffn_dgrad(
                hu["h"][:, rows], hu["u"][:, rows] if wu is not None
                else None, wi, wu, wo, plan.ffn_type, d, mm)
            for key, t in zip(kept, (d, act, dh, du)):
                kept[key].append(t)
            return plan.from_rows(dx.to(x_rows.dtype), recv.shape[1])

        def whole(key):
            parts = kept.pop(key)
            return torch.cat(parts, 1) if len(parts) > 1 else parts[0]

        def wgrad():
            hu.clear()
            du = whole("du") if wu is not None else None
            return ffn_wgrad(x_rows, whole("act"), whole("dh"), du,
                             whole("dy"), mm)

        # the return exchange's adjoint is the same exchange of dy, and
        # the dispatch's is the inverse one: the forward's pipeline
        dbuf, _, (dwi, dwu, dwo) = microop.pipelined_expert_ffn(
            dy, dgrad, plan.mesh, ctx.n, plan.e, shadow=recompute,
            tail=wgrad)
        return (dbuf, dwi.to(wi.dtype),
                dwu.to(wu.dtype) if dwu is not None else None,
                dwo.to(wo.dtype), None)


def dense_ffn(x, w_in, w_up, w_out, ffn_type: str):
    """The ScMoE shortcut's dense branch on [T, d] tokens."""
    h = x @ w_in
    h = F.silu(h) * (x @ w_up) if ffn_type == "swiglu" else gelu(h)
    return h @ w_out


def moe_layer(x, params: MoEParams, cfg: MoEConfig, *,
              ffn_type: str = "swiglu", dispatch_backend: str = "scatter",
              top_k: int | None = None, mesh=None, lina: bool = True,
              fsdp: bool = False, shortcut_params=None,
              expert_slicing: bool = False,
              tp_scatter: bool = False) -> MoEOutput:
    """x: [B, S, d], this rank's tokens -> MoEOutput on them.

    ``params`` hold this rank's experts: E / ep of them (``wi``, ``wu``,
    ``wo`` with leading dim E_local; ``convert.shard_params``), with
    ``expert_slicing`` (a mesh with `tp`) 1 / tp of their hidden dim (the
    ranks of a `tp` group must hold the same tokens), with ``fsdp`` 1 / dp
    of it, gathered here per layer over
    the data-parallel group (its backward a reduce-scatter).  The capacity
    comes from the local token count, as the reference's.  ``lina`` splits
    the exchange into ``cfg.n_microops`` micro-ops and, with
    ``cfg.pipeline_ffn``, pipelines them with the FFN; ``lina=False`` is
    one all-to-all, the whole FFN, one all-to-all.  ``shortcut_params``
    (``w_in``, ``w_up``, ``w_out``: the ScMoE dense branch) runs on the
    local tokens while the first dispatch all-to-all is in flight and is
    summed into the combine.  With a mesh the aux loss has the value of
    its mean over every rank (each holds its own tokens), the reference's
    ``pmean``, and this rank's own gradient (``world_mean_value``).

    With ``expert_slicing`` the experts' outputs are this rank's partial
    sums over `tp` (the reference's psum over `tp`): the sum is taken
    after the combine, which is linear, on y [B, S, d] (fewer rows than
    the capacity buffer): an all-reduce (autograd: dy summed too), or with
    ``tp_scatter`` (Megatron-SP) a reduce-scatter along the sequence (S
    must tile tp), y then this rank's [B, S / tp, d] and the shortcut's
    output cut to it."""
    b, s, d_model = x.shape
    x2 = x.reshape(b * s, d_model)
    e = cfg.n_experts
    k = top_k or cfg.top_k
    cap = capacity(b * s, e, k, cfg.capacity_factor)
    backend = resolve_backend(cfg.compute_backend)
    wi, wu, wo = params.wi, params.wu, params.wo
    if fsdp:
        if mesh is None:
            raise ValueError("fsdp shards the experts over a mesh's "
                             "data-parallel group: pass mesh=")
        wi = gather_hidden(wi, mesh, 2)
        wu = gather_hidden(wu, mesh, 2) if wu is not None else None
        wo = gather_hidden(wo, mesh, 1)
    g = router_top_k_gating(x2, params.router, k, cap, cfg.aux_loss_weight,
                            compute_backend=backend)
    disp, comb = D.get_backend(dispatch_backend)
    buf = disp(x2, g, e, cap)                                   # [E, C, d]

    def shortcut():
        return dense_ffn(x2, *shortcut_params, ffn_type)

    sc_out = None
    aux = g.aux_loss
    if mesh is None:
        # the kernel skips each expert's buffer rows past its kept count
        rows = kept_counts(g, e) if backend == "pallas" else None
        out_buf = expert_ffn(wi, wu, wo, buf, ffn_type, backend,
                             group_rows=rows)
        if shortcut_params is not None:
            sc_out = shortcut()
    else:
        # at ep 1 a chunk's rows are this rank's own: the kept counts say
        # which hold tokens.  At ep > 1 rows past a count are zeros, which
        # a bias-free FFN maps to zeros.
        rows = kept_counts(g, e) \
            if backend == "pallas" and mesh.size(axes.EP_AXIS) == 1 else None
        plan = _Plan(mesh, e, cfg.n_microops if lina else 1,
                     lina and cfg.pipeline_ffn, ffn_type, backend, rows,
                     shortcut if shortcut_params is not None else None)
        out_buf = _ExpertParallel.apply(buf, wi, wu, wo, plan)
        sc_out = plan.side
        aux = world_mean_value(aux, mesh)
    if counters.active():       # the (token, choice) pairs: routed, kept
        counters.add("moe.routed_pairs", b * s * k)
        counters.add("moe.kept_pairs",
                     (kept_counts(g, e) if rows is None else rows).sum())
    y = comb(out_buf, g, e, cap).reshape(b, s, d_model)
    if sc_out is not None:
        sc_out = sc_out.reshape(b, s, d_model)
    if expert_slicing and tp_scatter:     # the `tp` sum, to this rank's slice
        y = reduce_scatter_grad(y, mesh, mesh.group(axes.TP), 1)
        if sc_out is not None:
            k = s // mesh.size(axes.TP)
            sc_out = sc_out.narrow(1, mesh.index(axes.TP) * k, k)
    elif expert_slicing:                  # the `tp` sum
        y = all_reduce_grad(y, mesh, mesh.group(axes.TP))
    if sc_out is not None:
        y = y + sc_out                    # summed into the combine (ScMoE)
    return MoEOutput(y, aux, g.expert_idx, g.router_probs)
