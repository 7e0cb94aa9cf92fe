"""Serving-side MoE layer with Lina placement (replicated/packed experts),
in PyTorch on one rank.

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

This slice serves expert parallelism of 1: the reference's all-to-all to
slot owners and back are the identity, and all ``n_dev`` logical devices'
slots are computed here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.gating import capacity, router_top_k_gating
from repro_torch.core.moe import MoEParams, expert_ffn
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import invert_slots


class PlanArrays(NamedTuple):
    """Tensor (or, for the host mirror, numpy) form of a PlacementPlan."""
    slot_expert: torch.Tensor   # [n_dev, S] int32
    replica_of: torch.Tensor    # [E, R] int32 flat slot ids
    n_replicas: torch.Tensor    # [E] int32
    route_weight: Optional[torch.Tensor] = None  # [E, R] f32


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


def serve_moe_layer(x, params: MoEParams, cfg: MoEConfig, plan: PlanArrays,
                    *, ffn_type: str = "swiglu", top_k: int | None = None,
                    min_replicas: int = 1, cap_override: int = 0,
                    route_mode: str = "weighted"):
    """Inference MoE layer honoring a placement plan.  x: [T, d].

    ``min_replicas`` is the minimum live replica count across experts in
    ``plan`` (it shrinks per-slot buffers to ceil(cap / min_replicas));
    ``cap_override`` pins the per-expert gating capacity (sized from the
    valid token count by callers serving right-padded batches).
    Returns (y [T, d], expert_idx [T, k], router_probs [T, E])."""
    if route_mode not in ("weighted", "round_robin"):
        raise ValueError(f"unknown route_mode {route_mode!r}")
    k = top_k if top_k is not None else max(cfg.top_k, 1)
    if plan.route_weight is None:
        plan = plan._replace(route_weight=uniform_route_weight(
            plan.replica_of, plan.n_replicas))
    t, d_model = x.shape
    e = cfg.n_experts
    n_dev, s_pack = plan.slot_expert.shape
    cap = cap_override or capacity(t, e, k, cfg.capacity_factor)
    slot_cap = slot_capacity(cap, min_replicas)
    backend = kernel_ops.resolve_backend(cfg.compute_backend)
    g = router_top_k_gating(x, params.router, k, cap, cfg.aux_loss_weight,
                            compute_backend=backend)

    # --- route to replica slots instead of home experts -------------------
    n_slots = n_dev * s_pack
    if route_mode == "weighted":
        # kept positions of expert e are exactly 0..counts_e-1, so
        # position < sum(w_int) IS the capacity rule
        kept = (~g.dropped).to(torch.int32)
        counts = torch.zeros((e,), dtype=torch.int32, device=x.device) \
            .index_add_(0, g.expert_idx.reshape(-1).long(), kept.reshape(-1))
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
        dropped = rows < 0
    else:
        slots = route_to_slots(g.expert_idx, g.position, plan)     # [T, k]
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
    if backend == "pallas":
        src_tok, _ = invert_slots(rows, n_slots * slot_cap)
        buf = kernel_ops.dispatch_op(x, src_tok, rows)
    else:
        flat_idx = torch.where(rows < 0, torch.full_like(rows, n_slots
                                                         * slot_cap), rows)
        buf = torch.zeros((n_slots * slot_cap + 1, d_model), dtype=x.dtype,
                          device=x.device)
        src = x[:, None, :].expand(*rows.shape, d_model).reshape(-1, d_model)
        buf = buf.index_copy(0, flat_idx.reshape(-1).long(), src)[:-1]

    # --- hosted-expert weights (the §6.2 weight swap as a gather) ---------
    hosted = plan.slot_expert.reshape(n_slots).long()
    safe = torch.clamp(hosted, min=0)
    wi_h = params.wi[safe]
    wo_h = params.wo[safe]
    wu_h = params.wu[safe] if params.wu is not None else None

    # --- compute packed experts (§6.2) -------------------------------------
    toks = buf.reshape(n_slots, slot_cap, d_model)
    out = expert_ffn(wi_h, wu_h, wo_h, toks, ffn_type, backend)  # [S, n, d]
    out = out * (hosted >= 0).to(out.dtype)[:, None, None]
    flat = out.reshape(n_slots * slot_cap, d_model)

    # --- combine ------------------------------------------------------------
    w = torch.where(dropped, torch.zeros_like(g.gate_weights),
                    g.gate_weights)
    if backend == "pallas":
        y = kernel_ops.combine_op(flat, rows, w).to(x.dtype)
    else:
        vals = flat[torch.clamp(rows, min=0).long()]
        y = torch.sum(vals.float() * w[..., None], dim=1).to(x.dtype)
    return y, g.expert_idx, g.router_probs


def replica_token_counts(expert_idx, plan: PlanArrays, cap: int,
                         slot_cap: int, *, valid=None,
                         route_mode: str = "weighted") -> np.ndarray:
    """Host-side mirror of the device routing: realized *valid* token count
    per (device, sub-slot) under ``plan`` (numpy leaves).  expert_idx: [T, k]
    host ints over the full padded batch; valid: optional [T] bool.  The
    float steps of the weighted split run in numpy, operation for operation
    as the reference's mirror; the integer steps reuse the plain versions
    on CPU tensors.  Returns [n_slots] int64."""
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
    vc = np.ones(t, bool) if valid is None else np.asarray(valid, bool)
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
