"""Serving-side MoE layer with Lina placement (replicated/packed experts),
in PyTorch.

Serving dispatch routes a token to one of its expert's replica slots per
the ``PlacementPlan``, and every slot computes the expert packed into it.
Replica selection (§5/§6.2) has two modes:

  * ``"weighted"`` (default) — per-(expert, replica) integer routing
    weights from the realized post-gating histogram and the plan's
    ``route_weight`` fractions, then each kept (token, choice) goes to its
    replica bin by GShard priority position (the ``weighted_route``
    kernel).  Zero migration; no per-slot capacity recount.
  * ``"round_robin"`` — positional round-robin over replicas with a
    per-slot capacity recount (the ablation baseline).

Without a mesh the layer runs on one rank: all ``n_dev`` logical devices'
slots are computed here.  With a mesh (``launch.mesh``, the reference's
``shard_map`` body) the plan's ``n_dev`` logical devices map onto the ep
ranks of the `model` group, ``n_dev / ep`` each.  ``x`` is the global token
batch on every rank (the server runs attention and gating replicated);
each rank routes its `data` index's share of it over the global slot grid,
sends each slot owner its rows in one all-to-all, computes the experts its
logical devices host, sends the rows back and combines.  The ep ranks of
one `data` index route the same tokens, so each owner computes ep equal
copies of its rows, as the reference's layer does.  Every rank returns
the global outputs (all-gathered over `data`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import axes
from repro_torch.core.gating import (capacity, kept_counts,
                                     router_top_k_gating)
from repro_torch.core.microop import exchange
from repro_torch.core.collectives import gather_axis
from repro_torch.core.moe import MoEParams, expert_ffn
from repro_torch.devices import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import invert_slots


class PlanArrays(NamedTuple):
    """Tensor (or, for the host mirror, numpy) form of a PlacementPlan.

    A *stacked* PlanArrays carries one plan per MoE layer with a leading
    layer dim on every leaf (``slot_expert.ndim == 3``): the transformer
    serve entry points (``models.lm``) give each layer its own plan."""
    slot_expert: torch.Tensor   # [n_dev, S] int32    (stacked: [L, n_dev, S])
    replica_of: torch.Tensor    # [E, R] int32 flat slot ids  ([L, E, R])
    n_replicas: torch.Tensor    # [E] int32                   ([L, E])
    route_weight: Optional[torch.Tensor] = None  # [E, R] f32 ([L, E, R])

    @classmethod
    def from_plan(cls, plan, device="cuda") -> "PlanArrays":
        """A ``PlacementPlan`` on ``device`` (the card by default), with its
        route-weight fractions (``placement.route_weights``)."""
        from repro_torch.core.placement import route_weights
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        return cls(t(plan.slot_expert, torch.int32),
                   t(plan.replica_of, torch.int32),
                   t(plan.n_replicas, torch.int32),
                   t(route_weights(plan), torch.float32))

    @property
    def stacked(self) -> bool:
        return self.slot_expert.ndim == 3

    def layer(self, i: int) -> "PlanArrays":
        """Layer ``i``'s plan of a stacked PlanArrays."""
        return PlanArrays(*(None if a is None else a[i] for a in self))


def uniform_route_weight(replica_of, n_replicas):
    """[E, R] fractions splitting each expert evenly over its live
    replicas."""
    e, r_w = replica_of.shape
    ar = torch.arange(r_w, device=replica_of.device)
    live = ar[None, :] < torch.clamp(n_replicas, 1, r_w)[:, None]
    live = live & (replica_of >= 0)
    n_live = torch.clamp(live.sum(1, keepdim=True), min=1)
    return torch.where(live, 1.0 / n_live.float(),
                       torch.zeros((), device=replica_of.device))


def mask_dead_route_weights(route_weight, replica_of, s_pack, dead_devices):
    """Zero the route-weight columns of replicas hosted on dead devices and
    renormalize each row over the survivors (zero-migration degradation: the
    weighted split then sends them nothing).  Rows whose every replica is
    dead come back all-zero.  Host (numpy) tables, flat [E, R] or stacked
    [L, E, R]; the server masks before it uploads a plan."""
    dead = sorted(int(d) for d in dead_devices)
    if not dead:
        return route_weight
    replica_of = np.asarray(replica_of)
    dev = np.where(replica_of >= 0, replica_of // s_pack, -1)
    w = np.where(np.isin(dev, dead), 0.0,
                 np.asarray(route_weight, np.float32))
    tot = np.sum(w, axis=-1, keepdims=True)
    return np.where(tot > 0, w / np.maximum(tot, 1e-9), 0.0)


def stack_plan_arrays(plans, device="cuda") -> PlanArrays:
    """Stack per-layer plans (``PlacementPlan`` or ``PlanArrays``) into one
    stacked PlanArrays with a leading layer dim.  All plans must agree on
    device count and sub-slot count; replica tables are right-padded to the
    widest plan (-1 slot ids, 0.0 route weights) so the stack is
    rectangular.  ``PlacementPlan``s go to ``device`` (the card by
    default)."""
    arrs = [p if isinstance(p, PlanArrays) else PlanArrays.from_plan(
        p, device) for p in plans]
    if not arrs:
        raise ValueError("stack_plan_arrays needs at least one plan")
    shapes = {tuple(a.slot_expert.shape) for a in arrs}
    if len(shapes) != 1:
        raise ValueError(f"plans disagree on device layout: {shapes}")
    r = max(a.replica_of.shape[1] for a in arrs)

    def pad(a, fill):
        w = r - a.shape[1]
        return a if not w else torch.nn.functional.pad(a, (0, w),
                                                       value=fill)

    def rweight(a):
        if a.route_weight is not None:
            return a.route_weight
        return uniform_route_weight(a.replica_of, a.n_replicas)

    return PlanArrays(
        torch.stack([a.slot_expert for a in arrs]),
        torch.stack([pad(a.replica_of, -1) for a in arrs]),
        torch.stack([a.n_replicas for a in arrs]),
        torch.stack([pad(rweight(a).float(), 0.0) for a in arrs]))


def route_to_slots(expert_idx, position, plan: PlanArrays):
    """[T, k] expert choices -> [T, k] flat slot ids, round-robin over the
    expert's replicas by buffer position.  ``slot < 0`` means dropped."""
    r_w = plan.replica_of.shape[-1]
    idx = expert_idx.long()
    n_rep = torch.clamp(plan.n_replicas[idx], 1, r_w)               # [T, k]
    which = position.long() % n_rep
    return torch.gather(plan.replica_of[idx], -1, which[..., None])[..., 0]


def _np_integer_route_weights(counts, route_weight, n_replicas, slot_cap):
    """numpy form of ``integer_route_weights`` (the reference's ``xp=numpy``
    code, operation for operation)."""
    e, r_w = route_weight.shape
    counts = counts.astype(np.int32)
    live = np.arange(r_w, dtype=np.int32)[None, :] \
        < np.clip(n_replicas, 1, r_w).astype(np.int32)[:, None]
    frac = np.where(live, route_weight.astype(np.float32), 0.0)
    tot = np.sum(frac, axis=1, keepdims=True)
    live = live & ((frac > 0.0) | (tot <= 1e-9))
    n_live = np.maximum(np.sum(live.astype(np.int32), axis=1, keepdims=True),
                        1)
    uniform = np.where(live, 1.0 / n_live.astype(np.float32), 0.0)
    frac = np.where(tot > 1e-9, frac / np.maximum(tot, 1e-9), uniform)
    quota = counts[:, None].astype(np.float32) * frac
    base = np.floor(quota).astype(np.int32)
    fp = np.where(live, quota - base.astype(np.float32), -1.0)
    idx_r = np.arange(r_w, dtype=np.int32)
    beats = (fp[:, None, :] > fp[:, :, None]) | \
        ((fp[:, None, :] == fp[:, :, None])
         & (idx_r[None, None, :] < idx_r[None, :, None]))
    rank = np.sum(beats.astype(np.int32), axis=2)
    rem = np.maximum(counts - np.sum(base, axis=1), 0)
    base = base + ((rank < rem[:, None]) & live).astype(np.int32)
    base = np.minimum(base, slot_cap)
    head = np.where(live, slot_cap - base, 0)
    short = np.maximum(counts - np.sum(base, axis=1), 0)
    cum_prev = np.cumsum(head, axis=1) - head
    add = np.clip(short[:, None] - cum_prev, 0, head)
    return (base + add).astype(np.int32)


def integer_route_weights(counts, route_weight, n_replicas, slot_cap: int):
    """Realized per-expert token counts -> per-(expert, replica) integer
    routing weights (the §5 weighted zero-migration split).

    counts: [E] kept tokens per expert; route_weight: [E, R] fractions (0 on
    dead/pad columns); n_replicas: [E].  Returns [E, R] int32 with 0 on
    dead/pad columns, every entry <= slot_cap, row sums covering counts
    whenever the live replicas can hold them; largest-remainder
    apportionment ranked by an argsort-free [E, R, R] comparison count.
    numpy arrays in (the host mirror) give numpy out; tensors give tensors,
    with the same fp32 operations in the same order."""
    if isinstance(route_weight, np.ndarray):
        return _np_integer_route_weights(counts, route_weight, n_replicas,
                                         slot_cap)
    dev = route_weight.device
    e, r_w = route_weight.shape
    zero = torch.zeros((), device=dev)
    idx_r = torch.arange(r_w, dtype=torch.int32, device=dev)
    counts = counts.to(torch.int32)
    live = idx_r[None, :] < torch.clamp(n_replicas, 1, r_w).int()[:, None]
    frac = torch.where(live, route_weight.float(), zero)
    tot = frac.sum(1, keepdim=True)
    live = live & ((frac > 0.0) | (tot <= 1e-9))
    n_live = torch.clamp(live.int().sum(1, keepdim=True), min=1)
    uniform = torch.where(live, 1.0 / n_live.float(), zero)
    frac = torch.where(tot > 1e-9, frac / torch.clamp(tot, min=1e-9),
                       uniform)
    quota = counts[:, None].float() * frac
    base = torch.floor(quota).int()
    fp = torch.where(live, quota - base.float(),
                     torch.full((), -1.0, device=dev))
    beats = (fp[:, None, :] > fp[:, :, None]) | \
        ((fp[:, None, :] == fp[:, :, None])
         & (idx_r[None, None, :] < idx_r[None, :, None]))
    rank = beats.int().sum(2, dtype=torch.int32)
    rem = torch.clamp(counts - base.sum(1, dtype=torch.int32), min=0)
    base = base + ((rank < rem[:, None]) & live).int()
    base = torch.clamp(base, max=slot_cap)
    head = torch.where(live, slot_cap - base, torch.zeros_like(base))
    short = torch.clamp(counts - base.sum(1, dtype=torch.int32), min=0)
    cum_prev = torch.cumsum(head, dim=1, dtype=torch.int32) - head
    add = torch.minimum(torch.clamp(short[:, None] - cum_prev, min=0), head)
    return (base + add).to(torch.int32)


def _np_balanced_route_fractions(counts, route_weight, replica_of,
                                 n_replicas, n_dev, s_pack, rounds):
    """numpy form of ``balanced_route_fractions`` (the reference's
    ``xp=numpy`` code, operation for operation)."""
    e, r_w = replica_of.shape
    live = (np.arange(r_w, dtype=np.int32)[None, :]
            < np.clip(n_replicas, 1, r_w).astype(np.int32)[:, None]) \
        & (replica_of >= 0)
    dev = np.where(live, replica_of // s_pack, 0)
    live = live & (route_weight > 0)
    w = np.where(live, np.maximum(route_weight.astype(np.float32), 1e-6), 0.0)
    tot = np.sum(w, axis=1, keepdims=True)
    w = np.where(tot > 0, w / np.maximum(tot, 1e-9), 0.0)
    c = counts.astype(np.float32)[:, None]
    target = np.maximum(np.sum(c) / n_dev, 1e-9)
    oh = (dev.reshape(-1)[:, None]
          == np.arange(n_dev, dtype=np.int32)[None, :]).astype(np.float32)
    for _ in range(rounds):
        load = (w * c).reshape(-1) @ oh
        fac = np.clip(target / np.maximum(load, 1e-9), 0.1, 10.0)
        w = np.where(live, w * fac[dev], 0.0)
        w = w / np.maximum(np.sum(w, axis=1, keepdims=True), 1e-9)
    return w


def balanced_route_fractions(counts, route_weight, replica_of, n_replicas,
                             n_dev: int, s_pack: int, rounds: int = 4):
    """Realized per-expert token counts -> per-(expert, replica) fractions
    that balance this batch's per-device received tokens over the resident
    placement (§5's transfer balance on the realized histogram): the plan's
    ``route_weight`` seeds a few multiplicative rebalance rounds; exact-zero
    (dead / pad) columns stay 0.  ``replica_of`` holds flat slot ids over an
    [n_dev, s_pack] grid.  numpy in, numpy out (host mirror); tensors in,
    tensors out, fp32 in the reference's order of operations."""
    if isinstance(route_weight, np.ndarray):
        return _np_balanced_route_fractions(counts, route_weight, replica_of,
                                            n_replicas, n_dev, s_pack, rounds)
    device = route_weight.device
    e, r_w = replica_of.shape
    zero = torch.zeros((), device=device)
    live = (torch.arange(r_w, dtype=torch.int32, device=device)[None, :]
            < torch.clamp(n_replicas, 1, r_w).int()[:, None]) \
        & (replica_of >= 0)
    dev = torch.where(live, replica_of // s_pack,
                      torch.zeros_like(replica_of)).long()
    live = live & (route_weight > 0)
    w = torch.where(live, torch.clamp(route_weight.float(), min=1e-6), zero)
    tot = w.sum(1, keepdim=True)
    w = torch.where(tot > 0, w / torch.clamp(tot, min=1e-9), zero)
    c = counts.float()[:, None]
    target = torch.clamp(c.sum() / n_dev, min=1e-9)
    oh = (dev.reshape(-1)[:, None]
          == torch.arange(n_dev, device=device)[None, :]).float()
    for _ in range(rounds):
        load = (w * c).reshape(-1) @ oh
        fac = torch.clamp(target / torch.clamp(load, min=1e-9), 0.1, 10.0)
        w = torch.where(live, w * fac[dev], zero)
        w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-9)
    return w


def slot_capacity(cap: int, min_replicas: int) -> int:
    """Per (device, sub-slot) buffer capacity under replication:
    ceil(cap / min_replicas), floored at 8."""
    return max(8, -(-cap // max(1, min_replicas)))


def slot_rows(rows, n_slots: int, slot_cap: int):
    """[n_slots] int32: one past the highest buffer row routed into each
    slot (0 for a slot that received nothing), from the [T, k] flat rows
    (-1 dropped).  The weighted route fills a slot's rows from 0, so this
    is its count; the round-robin recount may leave holes below it."""
    used = rows >= 0
    slot = torch.where(used, rows // slot_cap, n_slots).reshape(-1).long()
    top = torch.where(used, rows % slot_cap + 1, 0).reshape(-1).int()
    return torch.zeros((n_slots + 1,), dtype=torch.int32,
                       device=rows.device).scatter_reduce_(
        0, slot, top, "amax")[:n_slots]


def dp_shard_count(mesh, n_tokens: int) -> int:
    """The data-parallel factor ``serve_moe_layer`` shards tokens by (1
    without a mesh, or when the token count does not tile the dp axes)."""
    if mesh is None:
        return 1
    sizes = axes.axis_sizes(mesh)
    dp_n = sizes.get(axes.POD, 1) * sizes.get(axes.DATA, 1)
    return dp_n if n_tokens % dp_n == 0 else 1


class HostedWeights(NamedTuple):
    """The expert weights one rank's logical devices host under a plan,
    one per hosted slot (an empty slot holds expert 0's, and computes
    zeros): [S_h, d, f] / [S_h, f, d] with S_h = n_dev / ep * s_pack."""
    wi: torch.Tensor
    wu: Optional[torch.Tensor]
    wo: torch.Tensor


def hosted_slots(plan: PlanArrays, mesh) -> torch.Tensor:
    """[S_h] expert id of each slot this rank's logical devices host (-1
    empty): the plan's rows m * group .. (m + 1) * group, m the rank's
    `model` index and group = n_dev / ep (all of them without a mesh)."""
    n_dev, s_pack = plan.slot_expert.shape
    if mesh is None:
        return plan.slot_expert.reshape(n_dev * s_pack)
    ep = mesh.size(axes.EP_AXIS)
    if n_dev % ep:
        raise ValueError(f"the plan's {n_dev} devices do not tile the "
                         f"expert-parallel group of {ep}")
    group = n_dev // ep
    m = mesh.index(axes.EP_AXIS)
    return plan.slot_expert[m * group:(m + 1) * group].reshape(group
                                                               * s_pack)


def fetch_hosted(params: MoEParams, plan: PlanArrays, mesh) -> HostedWeights:
    """The §6.2 weight swap: this rank's expert shard ([E / ep, ...],
    ``convert.shard_params``) all-gathered over the `model` group into the
    whole stack, then the hosted slots' experts selected (the reference's
    gather-then-select)."""
    safe = torch.clamp(hosted_slots(plan, mesh), min=0).long()

    def gather(w):
        return None if w is None else gather_axis(w, mesh, axes.EP_AXIS)[safe]
    return HostedWeights(gather(params.wi), gather(params.wu),
                         gather(params.wo))


def _route(x, router, cfg: MoEConfig, plan: PlanArrays, k: int, cap: int,
           slot_cap: int, backend: str, route_mode: str):
    """Gating and the replica split over the plan's whole slot grid:
    (GatingResult, rows [T, k] flat buffer rows with -1 dropped,
    dropped [T, k])."""
    e = cfg.n_experts
    n_dev, s_pack = plan.slot_expert.shape
    n_slots = n_dev * s_pack
    g = router_top_k_gating(x, router, k, cap, cfg.aux_loss_weight,
                            compute_backend=backend)
    if route_mode == "weighted":
        # kept positions of expert e are exactly 0..counts_e-1, so
        # position < sum(w_int) IS the capacity rule
        counts = kept_counts(g, e)
        fracs = balanced_route_fractions(counts, plan.route_weight,
                                         plan.replica_of, plan.n_replicas,
                                         n_dev, s_pack)
        w_int = integer_route_weights(counts, fracs, plan.n_replicas,
                                      slot_cap)
        cumw = torch.cumsum(w_int, dim=1, dtype=torch.int32)
        idx_kept = torch.where(g.dropped, torch.full_like(g.expert_idx, -1),
                               g.expert_idx)
        if backend == "pallas":
            rows = kernel_ops.weighted_route_op(idx_kept, g.position, cumw,
                                                plan.replica_of, slot_cap)
        else:
            rows = ref.ref_weighted_route(idx_kept, g.position, cumw,
                                          plan.replica_of.int(), slot_cap)
        return g, rows, rows < 0
    slots = route_to_slots(g.expert_idx, g.position, plan)        # [T, k]
    # position within the slot: recount capacity per slot (every row,
    # gating-dropped ones included, as the reference does)
    oh = (slots.long()[..., None] == torch.arange(
        n_slots, device=x.device)).to(torch.int32)
    flat = oh.reshape(-1, n_slots)
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = torch.sum(pos.reshape(*slots.shape, n_slots) * oh, dim=-1,
                    dtype=torch.int32)
    dropped = g.dropped | (pos >= slot_cap) | (slots < 0)
    rows = torch.where(dropped, torch.full_like(pos, -1),
                       (slots * slot_cap + pos).to(torch.int32))
    return g, rows, dropped


def _dispatch(x, rows, n_rows: int, backend: str):
    """[T, d] tokens into their [n_rows, d] slot-buffer rows (zeros where
    nothing was routed)."""
    if backend == "pallas":
        src_tok, _ = invert_slots(rows, n_rows)
        return kernel_ops.dispatch_op(x, src_tok, rows)
    d_model = x.shape[1]
    flat_idx = torch.where(rows < 0, torch.full_like(rows, n_rows), rows)
    buf = torch.zeros((n_rows + 1, d_model), dtype=x.dtype, device=x.device)
    src = x[:, None, :].expand(*rows.shape, d_model).reshape(-1, d_model)
    return buf.index_copy(0, flat_idx.reshape(-1).long(), src)[:-1]


def _ffn_in_place(params: MoEParams, toks, hosted, group_rows,
                  ffn_type: str, backend: str):
    """The experts of ``hosted`` [S] (-1 empty) on ``toks`` [S, n, d],
    from the whole expert stack ``params``."""
    if backend == "pallas":
        # the kernel reads each slot's hosted expert in place (-1: an empty
        # slot, zeros) and skips the slot rows past the last one routed
        return expert_ffn(params.wi, params.wu, params.wo, toks, ffn_type,
                          backend, group_expert=hosted.int(),
                          group_rows=group_rows)
    # the §6.2 weight swap as a gather of the hosted experts' weights
    hosted = hosted.long()
    safe = torch.clamp(hosted, min=0)
    wu_h = params.wu[safe] if params.wu is not None else None
    out = expert_ffn(params.wi[safe], wu_h, params.wo[safe], toks,
                     ffn_type, backend)                          # [S, n, d]
    return out * (hosted >= 0).to(out.dtype)[:, None, None]


def _ffn_fetched(hw: HostedWeights, toks, hosted, ffn_type: str,
                 backend: str):
    """The experts of ``hosted`` [S_h] (-1 empty) on ``toks`` [S_h, n, d],
    from the fetched per-slot weights ``hw``."""
    if backend == "pallas":
        ar = torch.arange(hosted.shape[0], dtype=torch.int32,
                          device=hosted.device)
        return expert_ffn(hw.wi, hw.wu, hw.wo, toks, ffn_type, backend,
                          group_expert=torch.where(hosted >= 0, ar, -1))
    out = expert_ffn(hw.wi, hw.wu, hw.wo, toks, ffn_type, backend)
    return out * (hosted >= 0).to(out.dtype)[:, None, None]


def _combine(flat, rows, g, dropped, backend: str, dtype):
    w = torch.where(dropped, torch.zeros_like(g.gate_weights),
                    g.gate_weights)
    if backend == "pallas":
        return kernel_ops.combine_op(flat, rows, w).to(dtype)
    vals = flat[torch.clamp(rows, min=0).long()]
    return torch.sum(vals.float() * w[..., None], dim=1).to(dtype)


def serve_moe_layer(x, params: MoEParams, cfg: MoEConfig, plan: PlanArrays,
                    *, ffn_type: str = "swiglu", top_k: int | None = None,
                    min_replicas: int = 1, cap_override: int = 0,
                    route_mode: str = "weighted", mesh=None,
                    hosted: Optional[HostedWeights] = None,
                    local: bool = False):
    """Inference MoE layer honoring a placement plan.  x: [T, d], the whole
    batch (on every rank of a mesh).

    ``min_replicas`` is the minimum live replica count across experts in
    ``plan`` (it shrinks per-slot buffers to ceil(cap / min_replicas));
    ``cap_override`` pins the per-expert gating capacity of one token
    shard (sized from the valid token count by callers serving
    right-padded batches).  With ``mesh`` (see the module doc) ``params``
    hold this rank's E / ep experts; at ep > 1 the hosted experts'
    weights are ``hosted`` when the caller fetched them for this plan
    (``fetch_hosted``), else fetched here.  Returns (y [T, d],
    expert_idx [T, k], router_probs [T, E]).  ``local``: x is this rank's
    token shard already (the dense-sharded entry points' batch rows), so
    it is neither cut over `data` nor gathered back."""
    if route_mode not in ("weighted", "round_robin"):
        raise ValueError(f"unknown route_mode {route_mode!r}")
    k = top_k if top_k is not None else max(cfg.top_k, 1)
    if plan.route_weight is None:
        plan = plan._replace(route_weight=uniform_route_weight(
            plan.replica_of, plan.n_replicas))
    t, d_model = x.shape
    dp_n = 1 if local else dp_shard_count(mesh, t)
    if dp_n > 1:
        t_loc = t // dp_n
        i = mesh.index(axes.DATA)
        x = x[i * t_loc:(i + 1) * t_loc]
    n_dev, s_pack = plan.slot_expert.shape
    n_slots = n_dev * s_pack
    cap = cap_override or capacity(x.shape[0], cfg.n_experts, k,
                                   cfg.capacity_factor)
    slot_cap = slot_capacity(cap, min_replicas)
    backend = kernel_ops.resolve_backend(cfg.compute_backend)
    g, rows, dropped = _route(x, params.router, cfg, plan, k, cap, slot_cap,
                              backend, route_mode)
    buf = _dispatch(x, rows, n_slots * slot_cap, backend)

    # --- a2a to slot owners: block j to rank j, received block j from
    # rank j (the source); no mesh is one rank and no exchange ------------
    ep = 1 if mesh is None else mesh.size(axes.EP_AXIS)
    hosted_ids = hosted_slots(plan, mesh)
    s_h = hosted_ids.shape[0]
    buf = buf.reshape(ep, s_h * slot_cap, d_model)
    if mesh is not None:
        buf = exchange(buf, mesh)
    toks = buf.reshape(ep, s_h, slot_cap, d_model).transpose(0, 1) \
        .reshape(s_h, ep * slot_cap, d_model)

    # --- compute packed experts (§6.2) --------------------------------------
    if ep == 1:
        # every slot is this rank's own: the weights are read in place and
        # each slot's routed rows bound the kernel's work
        out = _ffn_in_place(params, toks, hosted_ids,
                            slot_rows(rows, n_slots, slot_cap)
                            if backend == "pallas" else None,
                            ffn_type, backend)
    else:
        # the received rows are ep prefixes (one a source), which one count
        # a slot cannot bound: no group_rows
        hw = hosted if hosted is not None else \
            fetch_hosted(params, plan, mesh)
        out = _ffn_fetched(hw, toks, hosted_ids, ffn_type, backend)
    out = out.reshape(s_h, ep, slot_cap, d_model).transpose(0, 1) \
        .reshape(ep, s_h * slot_cap, d_model)
    # --- a2a back -----------------------------------------------------------
    if mesh is not None:
        out = exchange(out, mesh)
    flat = out.reshape(n_slots * slot_cap, d_model)

    # --- combine ------------------------------------------------------------
    y = _combine(flat, rows, g, dropped, backend, x.dtype)
    eidx, probs = g.expert_idx, g.router_probs
    if dp_n > 1:
        y, eidx, probs = (gather_axis(a, mesh, axes.DATA)
                          for a in (y, eidx, probs))
    return y, eidx, probs


def replica_token_counts(expert_idx, plan: PlanArrays, cap: int,
                         slot_cap: int, *, valid=None, dp_shards: int = 1,
                         route_mode: str = "weighted") -> np.ndarray:
    """Host-side mirror of the device routing: realized *valid* token count
    per (device, sub-slot) under ``plan`` (numpy leaves).  expert_idx: [T, k]
    host ints over the full padded batch; valid: optional [T] bool;
    dp_shards: the data-parallel factor ``serve_moe_layer`` used (each
    token shard routes on its own; the counts are summed).  The float steps
    of the weighted split run in numpy, operation for operation as the
    reference's mirror; the integer steps reuse the plain versions on CPU
    tensors.  Returns [n_slots] int64."""
    idx = np.asarray(expert_idx, np.int32)
    se = np.asarray(plan.slot_expert)
    ro = np.asarray(plan.replica_of, np.int32)
    nr = np.asarray(plan.n_replicas, np.int32)
    rw_tab = plan.route_weight
    if rw_tab is None:
        rw_tab = uniform_route_weight(torch.as_tensor(ro),
                                      torch.as_tensor(nr)).numpy()
    rw_tab = np.asarray(rw_tab, np.float32)
    e, r_w = ro.shape
    n_slots = int(se.size)
    t = idx.shape[0]
    v = np.ones(t, bool) if valid is None else np.asarray(valid, bool)
    shards = max(1, int(dp_shards))
    if t % shards:
        shards = 1
    out = np.zeros(n_slots, np.int64)
    for chunk, vc in zip(np.split(idx, shards), np.split(v, shards)):
        out += _shard_counts(chunk, vc, se, ro, nr, rw_tab, cap, slot_cap,
                             route_mode)
    return out


def _shard_counts(idx, vc, se, ro, nr, rw_tab, cap, slot_cap,
                  route_mode) -> np.ndarray:
    """``replica_token_counts`` of one token shard."""
    e, r_w = ro.shape
    n_slots = int(se.size)
    pos = ref.ref_topk_positions(torch.tensor(idx), e).numpy()
    dropped = (idx < 0) | (pos >= cap)
    counts = np.bincount(idx[~dropped].reshape(-1),
                         minlength=e).astype(np.int32)[:e]
    if route_mode == "weighted":
        n_dev_m, s_pack_m = se.shape
        fr = balanced_route_fractions(counts, rw_tab, ro, nr, n_dev_m,
                                      s_pack_m)
        w_int = integer_route_weights(counts, fr, nr, slot_cap)
        cum = np.cumsum(w_int, axis=1).astype(np.int32)
        rows = ref.ref_weighted_route(
            *(torch.tensor(a) for a in
              (np.where(dropped, -1, idx).astype(np.int32), pos, cum, ro)),
            slot_cap).numpy()
        keep = (rows >= 0) & vc[:, None]
        slots = rows[keep] // slot_cap
    else:
        safe = np.maximum(idx, 0)
        n_rep = np.clip(nr[safe], 1, r_w)
        which = pos % n_rep
        sl = np.take_along_axis(ro[safe], which[..., None], axis=-1)[..., 0]
        flat = sl.reshape(-1)
        soh = (flat[:, None] == np.arange(n_slots)[None, :])
        spos = ((np.cumsum(soh, axis=0) - soh) * soh).sum(1) \
            .reshape(idx.shape)
        keep = ~dropped & (sl >= 0) & (spos < slot_cap) & vc[:, None]
        slots = sl[keep]
    return np.bincount(slots, minlength=n_slots)[:n_slots].astype(np.int64)
