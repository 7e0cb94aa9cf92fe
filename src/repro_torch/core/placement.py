"""Lina §5 two-phase resource scheduling: Eq. 1 device counts, replication of
popular experts, first-fit-decreasing packing of unpopular ones, and the
phase-2 fine-tune check.

The planner runs on the host (numpy; it is the 'scheduler on device 0' of
§6.2) and emits static-shape plan arrays that the jitted serve step consumes:

  slot_expert  [n_devices, S]  expert hosted in each device sub-slot (-1 free)
  replica_of   [E, R]          device-slot index of each replica of e (-1 pad)
  n_replicas   [E]             live replica count per expert

Token routing: a token choosing expert e goes to replica (pos mod
n_replicas[e]) — balancing the a2a transfer size across the replicas' links,
which is exactly the paper's 'coordinate all-to-all correspondingly'.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.popularity import top2k_sets_match


@dataclass(frozen=True)
class PlacementPlan:
    slot_expert: np.ndarray    # [n_devices, S] int32
    replica_of: np.ndarray     # [E, R] int32 (flat slot ids; -1 pad)
    n_replicas: np.ndarray     # [E] int32
    popularity: np.ndarray     # [E] float32 — the estimate the plan used

    @property
    def n_devices(self) -> int:
        return self.slot_expert.shape[0]

    @property
    def max_pack(self) -> int:
        return self.slot_expert.shape[1]

    def device_load(self, popularity: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Token share per device under this plan.  By default evaluated
        against the popularity the plan was built from; pass the *actual*
        popularity to score the plan against the realized workload."""
        pop = self.popularity if popularity is None else \
            np.asarray(popularity, np.float64)
        load = np.zeros((self.n_devices,), np.float64)
        share = pop / np.maximum(self.n_replicas, 1)
        for d in range(self.n_devices):
            for s in range(self.max_pack):
                ex = self.slot_expert[d, s]
                if ex >= 0:
                    load[d] += share[ex]
        return load


def identity_plan(n_experts: int, n_devices: int, max_pack: int = 4,
                  max_replicas: int = 0) -> PlacementPlan:
    """Uniform baseline: expert e on device e*D//E (DeepSpeed layout)."""
    r = max_replicas or max_pack
    slot = np.full((n_devices, max_pack), -1, np.int32)
    rep = np.full((n_experts, r), -1, np.int32)
    per_dev = -(-n_experts // n_devices)          # ceil: experts per device
    assert per_dev <= max_pack, "identity layout exceeds max_pack"
    for e in range(n_experts):
        d, s = divmod(e, per_dev)
        slot[d, s] = e
        rep[e, 0] = d * max_pack + s
    pop = np.full((n_experts,), 1.0 / n_experts, np.float32)
    return PlacementPlan(slot, rep, np.ones((n_experts,), np.int32), pop)


def _poison_dead_bins(bin_load: np.ndarray, bin_count: np.ndarray,
                      dead_devices, max_pack: int) -> int:
    """Mark dead devices as full/infinitely loaded so every placement loop
    skips them without special-casing; returns the live device count."""
    dead = sorted(int(d) for d in (dead_devices or ()))
    for d in dead:
        if 0 <= d < bin_count.shape[0]:
            bin_count[d] = max_pack
            bin_load[d] = np.inf
    return bin_count.shape[0] - len(dead)


def plan_placement(popularity: np.ndarray, n_devices: int, max_pack: int = 4,
                   max_replicas: int = 0,
                   dead_devices=frozenset()) -> PlacementPlan:
    """Phase-1 planner (Eq. 1 + FFD).

    n_e = N * pop_e devices for expert e; experts with n_e >= 1 are
    *replicated* on round(n_e) devices; the fractional rest are packed
    first-fit-decreasing (item size = n_e, bin capacity = 1 device-worth of
    throughput, at most ``max_pack`` experts per device §6.2); experts not in
    any top-k list (pop 0) go to remaining free slots, else randomly.

    ``dead_devices`` masks failed devices out of the placement entirely
    (degradation path): no expert is placed on them, and the replica budget
    shrinks to the surviving slots.
    """
    e = popularity.shape[0]
    pop = np.asarray(popularity, np.float64)
    pop = pop / max(pop.sum(), 1e-12)
    max_replicas = max_replicas or max_pack

    slot_expert = np.full((n_devices, max_pack), -1, np.int32)
    bin_load = np.zeros((n_devices,), np.float64)
    bin_count = np.zeros((n_devices,), np.int32)
    live = _poison_dead_bins(bin_load, bin_count, dead_devices, max_pack)
    # over-subscription (e > live slots) keeps the legacy behavior: the
    # replica budget goes negative and the coldest experts are shed to
    # zero replicas (weighted_route drops their tokens on the -1 slot id)
    n_e = pop * live
    replicas: List[List[int]] = [[] for _ in range(e)]

    def place(ex: int, load: float) -> None:
        # first-fit over devices ordered by current load, respecting the
        # load cap when possible
        order = np.lexsort((np.arange(n_devices), bin_load))
        for d in order:
            if bin_count[d] < max_pack and (bin_load[d] + load <= 1.0 + 1e-9
                                            or bin_count[d] == 0):
                break
        else:
            # every bin is load-full: take the least-loaded device with a
            # free sub-slot regardless of cap (paper's 'randomly assigned')
            for d in order:
                if bin_count[d] < max_pack:
                    break
            else:
                raise ValueError("placement overflow: no free sub-slot")
        slot_expert[d, bin_count[d]] = ex
        replicas[ex].append(int(d * max_pack + bin_count[d]))
        bin_load[d] += load
        bin_count[d] += 1

    # 1) popular experts first, replicated proportionally (FFD = decreasing);
    # replica budget reserves one sub-slot per expert so nobody is orphaned.
    replica_budget = live * max_pack - e
    order = np.argsort(-n_e)
    for ex in order:
        ex = int(ex)
        r = int(min(max(1, round(n_e[ex])), max_replicas, live,
                    1 + replica_budget))
        replica_budget -= r - 1
        for _ in range(r):
            place(ex, n_e[ex] / r)

    rep = np.full((e, max_replicas), -1, np.int32)
    n_rep = np.zeros((e,), np.int32)
    for ex in range(e):
        rs = replicas[ex][:max_replicas]
        n_rep[ex] = len(rs)
        rep[ex, : len(rs)] = rs
    return PlacementPlan(slot_expert, rep, n_rep, pop.astype(np.float32))


def shed_to_budget(replica_counts: np.ndarray, popularity: np.ndarray,
                   budget: int) -> np.ndarray:
    """Shrink replica counts to a total slot budget: always decrement a
    least-popular expert among the widest.  The single shedding policy
    shared by ``plan_from_replicas`` and the controller's
    ``replica_targets`` — it preserves popularity-monotonicity of the
    counts, which the controller's tests pin."""
    r = np.asarray(replica_counts, np.int64).copy()
    pop = np.asarray(popularity, np.float64)
    if budget < r.shape[0]:
        raise ValueError(f"slot budget {budget} cannot host every one of "
                         f"{r.shape[0]} experts once")
    while r.sum() > budget:
        mx = r.max()
        cand = np.flatnonzero(r == mx)
        r[cand[np.argmin(pop[cand])]] -= 1
    return r


def plan_from_replicas(popularity: np.ndarray, replica_counts: np.ndarray,
                       n_devices: int, max_pack: int = 4,
                       rep_width: int = 0,
                       prev: Optional[PlacementPlan] = None,
                       dead_devices=frozenset()) -> PlacementPlan:
    """Build a plan honoring *explicit* per-expert replica counts — the
    constructor the adaptive controller (``repro.sched.controller``) uses,
    where Eq. 1's ``round(N * pop_e)`` is replaced by telemetry-driven
    targets (EWMA popularity + drift headroom).

    Each expert e gets exactly ``replica_counts[e]`` slots (clipped to
    [1, n_devices] and, collectively, to the ``n_devices * max_pack`` slot
    budget — largest counts shed first).  Replicas are placed greedily on
    the least-loaded device that (a) has a free sub-slot and (b) does not
    already host e (falling back to any free sub-slot when every device
    hosts it), so one expert's replicas spread across links — the §5
    transfer-balance objective.

    ``prev`` makes the placement *incremental*: up to the new count, an
    expert keeps the devices that already host it, so a swap only moves
    the weights of genuinely added replicas (minimizing the §6.2 weight
    swap the controller's migration model charges for).

    ``rep_width`` fixes the replica-table width (default ``n_devices``) so
    controller-emitted plans keep a static shape across swaps and never
    force a dispatch recompile.

    ``dead_devices`` (degradation path) removes failed devices from the
    placement: retained-from-``prev`` replicas on dead devices are dropped,
    nothing new lands there, and both the per-expert clip and the slot
    budget shrink to the surviving devices.
    """
    pop = np.asarray(popularity, np.float64)
    pop = pop / max(pop.sum(), 1e-12)
    e = pop.shape[0]
    dead = {int(d) for d in (dead_devices or ()) if 0 <= d < n_devices}
    live = n_devices - len(dead)
    r = np.clip(np.asarray(replica_counts, np.int64), 1, max(live, 1))
    budget = live * max_pack
    if budget < e:
        raise ValueError(f"{live} live devices x {max_pack} slots cannot "
                         f"host {e} experts")
    r = shed_to_budget(r, pop, budget)
    rep_width = rep_width or n_devices

    keep: List[List[int]] = [[] for _ in range(e)]
    if prev is not None and prev.n_devices == n_devices:
        for d in range(n_devices):
            if d in dead:
                continue
            for ex in prev.slot_expert[d]:
                ex = int(ex)
                if ex >= 0 and len(keep[ex]) < int(r[ex]) \
                        and d not in keep[ex]:
                    keep[ex].append(d)

    slot_expert = np.full((n_devices, max_pack), -1, np.int32)
    bin_load = np.zeros((n_devices,), np.float64)
    bin_count = np.zeros((n_devices,), np.int32)
    _poison_dead_bins(bin_load, bin_count, dead, max_pack)
    replicas: List[List[int]] = [[] for _ in range(e)]

    def assign(ex: int, d: int, share: float) -> None:
        slot_expert[d, bin_count[d]] = ex
        replicas[ex].append(int(d * max_pack + bin_count[d]))
        bin_load[d] += share
        bin_count[d] += 1

    for ex in np.argsort(-pop):                 # heaviest experts first
        ex = int(ex)
        share = pop[ex] / r[ex]
        retained = [d for d in keep[ex] if bin_count[d] < max_pack]
        for d in retained:
            assign(ex, d, share)
        for _ in range(int(r[ex]) - len(retained)):
            order = np.lexsort((np.arange(n_devices), bin_load))
            hosting = {s // max_pack for s in replicas[ex]}
            free = [d for d in order if bin_count[d] < max_pack]
            if not free:
                raise ValueError("placement overflow: no free sub-slot")
            spread = [d for d in free if d not in hosting]
            assign(ex, (spread or free)[0], share)

    rep = np.full((e, rep_width), -1, np.int32)
    n_rep = np.zeros((e,), np.int32)
    for ex in range(e):
        rs = replicas[ex][:rep_width]
        n_rep[ex] = len(rs)
        rep[ex, : len(rs)] = rs
    return PlacementPlan(slot_expert, rep, n_rep, pop.astype(np.float32))


def route_weights(plan: PlacementPlan, rounds: int = 6) -> np.ndarray:
    """Per-(expert, replica) routing fractions that balance modeled
    per-DEVICE token load under the plan's popularity — the starting point
    of the §5 weighted zero-migration split (``serving.PlanArrays``).

    Round-robin gives every replica of an expert 1/r of its tokens, so a
    replica that shares its device with other hot experts still eats the
    straggler.  A few rounds of iterative proportional fitting fix that:
    start uniform over live replicas, compute each device's modeled load
    (sum over hosted replicas of weight * expert popularity), and divide
    every replica's weight by its device's relative load, renormalizing
    per expert.  Rows sum to 1 over live replicas; pad/dead columns are 0.
    """
    ro = np.asarray(plan.replica_of, np.int64)
    nr = np.asarray(plan.n_replicas, np.int64)
    e, r_w = ro.shape
    pop = np.asarray(plan.popularity, np.float64)
    pop = pop / max(pop.sum(), 1e-12)
    live = (np.arange(r_w)[None, :] < np.clip(nr, 1, r_w)[:, None]) \
        & (ro >= 0)
    dev = np.clip(ro, 0, None) // max(plan.max_pack, 1)          # [E, R]
    n_live = np.maximum(live.sum(1, keepdims=True), 1)
    w = np.where(live, 1.0 / n_live, 0.0)
    for _ in range(max(0, int(rounds))):
        load = np.zeros(plan.n_devices, np.float64)
        np.add.at(load, dev[live], (w * pop[:, None])[live])
        rel = load / max(load.mean(), 1e-12)
        w = np.where(live, w / np.maximum(rel[dev], 1e-6), 0.0)
        w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def transfer_balance_cost(plan: PlacementPlan,
                          popularity: np.ndarray) -> float:
    """The §5 objective the controller minimizes: the *maximum* per-device
    token share under ``popularity`` — proportional to the largest
    all-to-all transfer any link carries (the layer's straggler)."""
    return float(plan.device_load(np.asarray(popularity, np.float64)).max())


def migration_slots(old: PlacementPlan, new: PlacementPlan) -> int:
    """Weight-movement cost of swapping ``old`` for ``new``: the number of
    (device, expert) placements present in the new plan but not the old —
    each one is an expert weight stack some device must fetch (§6.2's
    weight swap)."""
    moved = 0
    for d in range(new.n_devices):
        old_hosted = set(int(x) for x in old.slot_expert[d] if x >= 0) \
            if d < old.n_devices else set()
        for ex in new.slot_expert[d]:
            if ex >= 0 and int(ex) not in old_hosted:
                moved += 1
    return moved


def needs_finetune(est_pop: np.ndarray, actual_pop: np.ndarray,
                   top_k: int) -> bool:
    """Phase 2 (§5.2): fine-tune iff top-2k estimated != top-2k actual.
    Delegates to the canonical check in ``core.popularity``."""
    return not top2k_sets_match(est_pop, actual_pop, top_k)


def two_phase_plan(est_pop: np.ndarray, actual_pop: Optional[np.ndarray],
                   n_devices: int, top_k: int, max_pack: int = 4):
    """Returns (plan, finetuned: bool).  Phase 1 always plans from the
    estimate; phase 2 re-plans from the actual popularity on deviation."""
    plan = plan_placement(est_pop, n_devices, max_pack)
    if actual_pop is not None and needs_finetune(est_pop, actual_pop, top_k):
        return plan_placement(actual_pop, n_devices, max_pack), True
    return plan, False


@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0      # misses caused by popularity drift
    device_invalidations: int = 0   # entries dropped by a device failure

    @property
    def reuse_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class PlanCache:
    """Per-MoE-layer PlacementPlan cache for the serving engine.

    Phase-1 planning amortizes across batches: a layer's cached plan is
    reused while the top-2k set of the incoming popularity estimate still
    matches the top-2k set of the popularity the plan was built from (the
    same §5.2 drift criterion as the phase-2 fine-tune check).  On drift the
    entry is invalidated and the caller re-plans.
    """

    top_k: int = 1
    _plans: Dict[int, PlacementPlan] = field(default_factory=dict)
    stats: PlanCacheStats = field(default_factory=PlanCacheStats)

    def lookup(self, layer: int, popularity: np.ndarray
               ) -> Optional[PlacementPlan]:
        plan = self._plans.get(layer)
        if plan is None:
            self.stats.misses += 1
            return None
        if top2k_sets_match(plan.popularity, popularity, self.top_k):
            self.stats.hits += 1
            return plan
        self.stats.invalidations += 1
        self.stats.misses += 1
        del self._plans[layer]
        return None

    def store(self, layer: int, plan: PlacementPlan) -> None:
        self._plans[layer] = plan

    def invalidate_devices(self, dead_devices) -> int:
        """Drop every cached plan that places an expert on a dead device —
        the failure-time companion of the drift invalidation.  Returns the
        number of entries dropped."""
        dead = [int(d) for d in dead_devices]
        doomed = [layer for layer, plan in self._plans.items()
                  if any(0 <= d < plan.n_devices
                         and (plan.slot_expert[d] >= 0).any() for d in dead)]
        for layer in doomed:
            del self._plans[layer]
        self.stats.device_invalidations += len(doomed)
        return len(doomed)

    def clear(self) -> None:
        self._plans.clear()
