"""Telemetry-driven expert autoscaling: the actuation half of the loop.

Every ``interval`` engine steps the controller recomputes, per MoE layer, a
candidate ``PlacementPlan`` from the telemetry bus:

  replica targets   drift-scaled water-filling of the slot budget
                    (``replica_targets``): ``fill + headroom * drift`` of
                    the spare slots, apportioned proportionally to the
                    EWMA popularity — where Eq. 1 sized replicas against
                    N devices under the fixed ``max_pack`` cap, the
                    controller scales the budget itself, so a fast-moving
                    hot set keeps spare replicas warm;
  placement         ``core.placement.plan_from_replicas`` — greedy
                    least-loaded placement that spreads one expert's
                    replicas across devices (the §5 transfer-balance
                    objective) with a fixed replica-table width so swaps
                    never change dispatch shapes;
  swap decision     hysteresis: the candidate replaces the live plan only
                    when the §5 objective (max per-device token share,
                    ``transfer_balance_cost``) improves by more than
                    ``hysteresis`` relative PLUS the modeled migration cost
                    (``migration_slots`` — expert weight stacks devices
                    would have to fetch, weighted by ``migration_weight``).
                    A per-layer ``min_swap_interval`` additionally spaces
                    swaps out.  Both bound plan churn.

``AdaptiveScheduler`` packages bus + controller + server: the engine calls
``after_step`` between micro-batches, and accepted plans are published into
the server (``MoEServer.publish_plans``), replacing the static per-batch
planner for those layers.  In-flight decode state is untouched by a swap —
plans move experts, not math.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.placement import (PlacementPlan, migration_slots,
                                  plan_from_replicas, shed_to_budget,
                                  transfer_balance_cost)
from repro_torch.sched.telemetry import TelemetryBus, TelemetryConfig

# bytes of one element of a config's compute dtype (numpy has no bfloat16)
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class ControllerConfig:
    interval: int = 4            # engine steps between evaluations
    headroom: float = 0.2        # drift -> uniform-hedge gain
    risk: float = 1.0            # std multiplier of the popularity envelope
    fill: float = 1.0            # fraction of spare slots to use
    replica_floor: int = 0       # min replicas per expert (0 = auto)
    max_moves: int = 6           # replica adds per layer per control step
    #                              (migration throttle; 0 = unthrottled)
    hysteresis: float = 0.1      # min relative objective improvement to swap
    min_swap_interval: int = 0   # steps between swaps per layer (0: interval)
    migration_weight: float = 0.05  # objective units per migrated slot share
    max_replicas: int = 0        # per-expert replica cap (0: n_devices)
    min_observations: int = 2    # bus observations before the first plan


def replica_targets(popularity: np.ndarray, n_devices: int,
                    drift_rate: float = 0.0, headroom: float = 1.0,
                    max_replicas: int = 0, budget: int = 0,
                    fill: float = 1.0, floor: int = 0) -> np.ndarray:
    """Per-expert replica counts from observed popularity: water-filling of
    the slot budget with a drift-scaled hedge and a replica floor.

    Where Eq. 1 sizes replicas against ``n_devices`` under the fixed
    ``max_pack`` cap, the controller treats the WHOLE slot budget as the
    scaling resource: ``fill`` of the spare slots (beyond the floor) are
    apportioned proportionally to popularity (floor + largest-remainder).
    Two robustness levers cover what a time-averaged basis cannot see:

      - ``floor`` replicas per expert (default: 2 when the budget leaves
        at least ~half the spare slots free afterwards, else 1) bound the
        straggler cost of an expert that is cold on average but spikes hot
        in a single micro-batch — per-batch sampling noise;
      - the apportionment basis is blended toward uniform by
        ``headroom * drift_rate`` — the drift-scaled headroom: on a
        fast-moving layer the incoming hot experts (which the EWMA lags)
        hold spare replicas *before* their traffic lands.

    Monotone in popularity (pop_i >= pop_j implies r_i >= r_j): the blend
    and quotas are monotone maps, largest-remainder apportionment serves
    the larger quota first among equal floors, and budget shedding always
    decrements a least-popular expert among the widest.
    """
    pop = np.asarray(popularity, np.float64)
    pop = pop / max(pop.sum(), 1e-12)
    e = pop.shape[0]
    max_replicas = max_replicas or n_devices
    budget = budget or n_devices
    assert budget >= e, "budget must host every expert once"
    if not floor:
        floor = 2 if budget >= 2 * e + (budget - e) // 2 else 1
    floor = max(1, min(floor, budget // e))
    lam = float(np.clip(headroom * np.clip(drift_rate, 0.0, 1.0), 0.0, 0.9))
    pop_h = (1.0 - lam) * pop + lam / e
    target = floor * e + int(round((budget - floor * e) *
                                   float(np.clip(fill, 0.0, 1.0))))
    quota = pop_h * target
    r = np.maximum(floor, np.floor(quota).astype(np.int64))
    r = np.minimum(r, min(max_replicas, n_devices))
    spare = target - int(r.sum())
    if spare > 0:
        # remainder RELATIVE TO the floored/clipped count: an expert the
        # floor already lifted above its quota has a negative remainder,
        # so it cannot outrank a more popular expert at the same count
        # (keeps the apportionment monotone in popularity)
        rem = quota - r
        for ex in np.lexsort((-pop_h, -rem)):     # largest remainder first
            if spare <= 0:
                break
            if r[ex] < min(max_replicas, n_devices):
                r[ex] += 1
                spare -= 1
    return shed_to_budget(r, pop_h, budget)


class AutoscaleController:
    """Recomputes per-layer plans from telemetry; hysteresis bounds churn."""

    def __init__(self, n_devices: int, max_pack: int = 4,
                 cfg: Optional[ControllerConfig] = None):
        self.n_devices = n_devices
        self.max_pack = max_pack
        self.cfg = cfg or ControllerConfig()
        self.dead_devices: set = set()   # masked out of every candidate
        self.plans: Dict[int, PlacementPlan] = {}     # live published plans
        self._last_swap: Dict[int, int] = {}
        self.evaluations = 0
        self.swaps = 0          # re-plans of a live layer (the churn metric)
        self.bootstraps = 0     # first publish per layer (not churn)
        self.steps_seen = 0
        self.migrated_slots = 0      # cumulative expert stacks moved (swaps)
        self.pending_migration = 0   # slots moved since last pop_migration()

    def pop_migration(self) -> int:
        """Expert weight stacks moved by swaps since the last call — the
        benchmark's service model charges their transfer time to the step
        that performs the migration."""
        m = self.pending_migration
        self.pending_migration = 0
        return m

    # --- candidate construction --------------------------------------------
    def candidate(self, popularity: np.ndarray, drift_rate: float,
                  prev: Optional[PlacementPlan] = None) -> PlacementPlan:
        live = self.n_devices - len(self.dead_devices)
        r = replica_targets(popularity, live, drift_rate,
                            headroom=self.cfg.headroom,
                            fill=self.cfg.fill,
                            floor=self.cfg.replica_floor,
                            max_replicas=self.cfg.max_replicas,
                            budget=live * self.max_pack)
        if prev is not None and self.cfg.max_moves:
            r = self._throttle(r, prev, popularity)
        return plan_from_replicas(popularity, r, self.n_devices,
                                  max_pack=self.max_pack,
                                  rep_width=self.n_devices, prev=prev,
                                  dead_devices=self.dead_devices)

    def _throttle(self, target: np.ndarray, prev: PlacementPlan,
                  pop: np.ndarray) -> np.ndarray:
        """Migration throttle: move replica counts at most ``max_moves``
        additions toward the target per control step (weights are copied in
        the background in a real deployment — §6.2's weight swap — so each
        step's swap stays a bounded, absorbable cost instead of a storm).
        Additions are funded by shedding from the most over-target experts
        (coldest first), largest-deficit hottest experts served first."""
        cur = np.asarray(prev.n_replicas, np.int64).copy()
        deficit = target - cur
        adds = self.cfg.max_moves
        order = np.lexsort((-pop, -deficit))      # biggest deficit, hottest
        for ex in order:
            if adds <= 0 or deficit[ex] <= 0:
                break
            grant = int(min(deficit[ex], adds))
            cur[ex] += grant
            adds -= grant
        budget = (self.n_devices - len(self.dead_devices)) * self.max_pack
        while cur.sum() > budget:
            over = cur - target
            mx = over.max()
            if mx <= 0:
                cand = np.flatnonzero(cur == cur.max())
            else:
                cand = np.flatnonzero(over == mx)
            cur[cand[np.argmin(pop[cand])]] -= 1
        return np.maximum(cur, 1)

    # --- the control step ---------------------------------------------------
    def step(self, bus: TelemetryBus, step_idx: int
             ) -> Optional[Dict[int, PlacementPlan]]:
        """Evaluate every observed layer; returns the plans that changed
        (to publish), or None when nothing swapped this step."""
        cfg = self.cfg
        self.steps_seen = step_idx
        # bootstrap runs as soon as a layer has telemetry (every pre-plan
        # step is a step the per-batch planner still owns); steady-state
        # re-evaluation runs at the interval cadence
        unplanned = any(li not in self.plans for li in bus.layers())
        if step_idx % max(cfg.interval, 1) and not unplanned:
            return None
        min_gap = cfg.min_swap_interval or cfg.interval
        total_slots = self.n_devices * self.max_pack
        changed: Dict[int, PlacementPlan] = {}
        for li in bus.layers():
            lt = bus.layer(li)
            if lt is None or lt.steps < cfg.min_observations:
                continue
            if step_idx - self._last_swap.get(li, -min_gap) < min_gap:
                continue
            # plan against the envelope (mean + risk*std of per-batch
            # shares): replica width must cover what an expert can draw in
            # one micro-batch, not just its time-averaged share
            pop = bus.popularity_envelope(li, self.cfg.risk)
            if pop is None:
                continue
            self.evaluations += 1
            cur = self.plans.get(li)
            cand = self.candidate(pop, bus.drift_rate(li), prev=cur)
            if cur is not None:
                # both plans are scored on the CURRENT EWMA: the live plan
                # was fitted to an older average, so its score decays as
                # the distribution moves, while single-batch spikes (which
                # the replica floor already covers) cannot thrash the gate
                j_cur = transfer_balance_cost(cur, pop)
                j_new = transfer_balance_cost(cand, pop)
                mslots = migration_slots(cur, cand)
                gain = j_cur - j_new
                if gain <= cfg.hysteresis * j_cur + \
                        cfg.migration_weight * (mslots / total_slots):
                    continue                      # not worth the churn
                self.swaps += 1
                self.migrated_slots += mslots
                self.pending_migration += mslots
            else:
                self.bootstraps += 1
            self.plans[li] = cand
            self._last_swap[li] = step_idx
            changed[li] = cand
        return changed or None

    @property
    def churn_per_100_steps(self) -> float:
        """Plan swaps per 100 engine steps — the churn metric hysteresis
        bounds (layer-swaps, summed over layers)."""
        return 100.0 * self.swaps / max(self.steps_seen, 1)


class AdaptiveScheduler:
    """Bus + controller + server, packaged for the serving engine.

    The engine calls ``after_step(stats, n_tokens)`` between micro-batches;
    telemetry is recorded, the controller runs at its cadence, and accepted
    plans are published into the server.  Construction wires the modeled
    a2a byte size from the server's model config.
    """

    def __init__(self, server, ccfg: Optional[ControllerConfig] = None,
                 tcfg: Optional[TelemetryConfig] = None):
        if tcfg is None:
            itemsize = ITEMSIZE[server.cfg.dtype]
            tcfg = TelemetryConfig(
                top_k=server.scfg.top_k,
                bytes_per_token=float(server.cfg.d_model * itemsize))
        self.server = server
        # the operator view rides the server's shared obs registry; the bus
        # itself stays the policy view the controller plans from
        obs = getattr(server, "obs", None)
        self.bus = TelemetryBus(tcfg,
                                metrics=None if obs is None else obs.metrics)
        self.controller = AutoscaleController(server.n_dev,
                                              max_pack=server.scfg.max_pack,
                                              cfg=ccfg)
        self.step_idx = 0

    def after_step(self, stats: List, n_tokens: int) -> bool:
        """Returns True when a plan swap was published this step.

        The control step is exception-isolated (always-on degradation): a
        crashing controller leaves the last published plans serving and
        lands on the bus's error ledger instead of taking the serving loop
        down with it."""
        self.step_idx += 1
        self.bus.observe_step(stats, n_tokens)
        cache = getattr(self.server, "plan_cache", None)
        if cache is not None:
            self.bus.observe_cache(cache.stats)
        try:
            plans = self.controller.step(self.bus, self.step_idx)
        except Exception:
            self.bus.record_error("controller_step")
            plans = None
        if plans:
            self.server.publish_plans(plans)
            if self.bus.metrics is not None:
                self.bus.metrics.counter(
                    "sched_plan_swaps_total").inc(len(plans))
            return True
        return False

    # --- graceful degradation (repro_torch.resilience) ---------------------
    def fail_devices(self, devices) -> None:
        """Propagate a device failure through the whole control loop: the
        controller masks the devices out of every future candidate, its
        live plans touching them are dropped (an unplanned layer triggers
        an immediate re-bootstrap at the next step, bypassing the interval
        and swap-gap gating), and the server re-routes around them now."""
        devs = {int(d) for d in devices}
        self.controller.dead_devices |= devs
        for li, plan in list(self.controller.plans.items()):
            dead_slots = plan.slot_expert[sorted(
                d for d in devs if d < plan.n_devices)]
            if (np.asarray(dead_slots) >= 0).any():
                del self.controller.plans[li]
                self.controller._last_swap.pop(li, None)
        self.server.fail_devices(devs)

    def revive_devices(self, devices) -> None:
        devs = {int(d) for d in devices}
        self.controller.dead_devices -= devs
        self.server.revive_devices(devs)

    @property
    def churn_per_100_steps(self) -> float:
        return self.controller.churn_per_100_steps

    def report(self) -> dict:
        return {
            "steps": self.step_idx,
            "swaps": self.controller.swaps,
            "bootstraps": self.controller.bootstraps,
            "evaluations": self.controller.evaluations,
            "churn_per_100_steps": self.churn_per_100_steps,
            "telemetry": self.bus.snapshot(),
        }
