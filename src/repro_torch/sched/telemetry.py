"""Per-layer serving telemetry: the observation half of the control loop.

The engine feeds the bus once per micro-batch with the ``LayerStats`` the
server produced (realized expert popularity, per-device token shares,
fine-tune / plan-reuse flags) plus the token count served; the bus keeps
EWMAs so the controller sees a smoothed, recency-weighted view:

  popularity   EWMA of the realized per-layer expert histogram — what the
               controller plans from (not the per-batch estimate, which
               autoscaled serving no longer blocks on);
  drift rate   EWMA of the §5.2 top-2k-set-changed indicator between
               consecutive observations — how fast this layer's hot set is
               moving, which scales the controller's replica headroom;
  device load  EWMA of max/mean per-device token share under the active
               plan, and the modeled per-device a2a bytes it implies;
  plan cache   hit / miss / drift-invalidation *rates* derived from the
               PlanCache counter deltas between observations.

Everything is plain numpy on the host — the bus sits next to the planner
('scheduler on device 0', §6.2), never inside jit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.popularity import top2k_sets_match


@dataclass(frozen=True)
class TelemetryConfig:
    alpha: float = 0.25          # EWMA weight of the newest popularity obs
    slow_alpha: float = 0.0625   # slow-EWMA weight (drift reference)
    drift_alpha: float = 0.125   # EWMA weight of the drift indicator
    top_k: int = 1               # top-2k set size for the drift indicator
    bytes_per_token: float = 0.0  # d_model * itemsize; 0 = bytes not modeled
    obs_tokens_ref: float = 64.0  # obs weight saturates at this token count
    #                               (a 2-token decode batch moves the EWMA
    #                               1/32 as much as a full prefill; 0 = off)


@dataclass
class LayerTelemetry:
    """EWMA state for one MoE layer."""
    n_experts: int
    popularity: Optional[np.ndarray] = None   # [E] EWMA, sums to ~1
    popularity_var: Optional[np.ndarray] = None   # [E] EWMA batch variance
    popularity_slow: Optional[np.ndarray] = None  # [E] slow EWMA (reference)
    drift_rate: float = 0.0                   # in [0, 1]
    load_max: float = 0.0                     # EWMA max device token share
    load_mean: float = 0.0                    # EWMA mean device token share
    tokens: float = 0.0                       # EWMA tokens per observation
    rep_max: float = 0.0                      # EWMA max per-replica tokens
    rep_mean: float = 0.0                     # EWMA mean per-replica tokens
    steps: int = 0
    finetunes: int = 0
    reuses: int = 0
    _last_pop: Optional[np.ndarray] = None

    @property
    def imbalance(self) -> float:
        """max/mean device token share — 1.0 is perfectly balanced."""
        return self.load_max / self.load_mean if self.load_mean > 0 else 0.0

    @property
    def replica_imbalance(self) -> float:
        """max/mean realized tokens per placement slot — how evenly the
        weighted router spreads an expert's load over its replicas (the
        quantity Lina's weighted scheduling targets; 1.0 = perfectly even,
        0.0 = not yet observed)."""
        return self.rep_max / self.rep_mean if self.rep_mean > 0 else 0.0

    def a2a_bytes(self, bytes_per_token: float) -> float:
        """Modeled bytes the most-loaded device's link carries per step
        (dispatch + combine) under the observed load."""
        return 2.0 * self.tokens * self.load_max * bytes_per_token


class TelemetryBus:
    """Collects per-layer serving metrics; the controller reads snapshots.

    The bus remains the scheduling-POLICY view (EWMAs the controller plans
    from).  Pass a ``repro_torch.obs.MetricsRegistry`` as ``metrics`` to also
    publish the operator view: drift/imbalance gauges per layer, cache-rate
    gauges, and the error ledger as labeled counters."""

    def __init__(self, cfg: Optional[TelemetryConfig] = None, metrics=None):
        self.cfg = cfg or TelemetryConfig()
        self.metrics = metrics
        self._layers: Dict[int, LayerTelemetry] = {}
        self._cache_last = (0, 0, 0)      # (hits, misses, invalidations)
        self.cache_rates = {"hit": 0.0, "miss": 0.0, "invalidation": 0.0}
        self.steps = 0
        # error ledger (repro_torch.resilience): rejected-telemetry and
        # isolated control-loop failures land here instead of crashing the
        # loop
        self.errors: Dict[str, int] = {}

    def record_error(self, kind: str) -> None:
        """Count a named control-plane error (e.g. ``controller_step``,
        ``telemetry_rejected``) — the observability half of exception
        isolation: degraded, but never silent."""
        self.errors[kind] = self.errors.get(kind, 0) + 1
        if self.metrics is not None:
            self.metrics.counter("sched_bus_errors_total", kind=kind).inc()

    @staticmethod
    def _valid_obs(pop: np.ndarray, load: np.ndarray) -> bool:
        """A corrupted snapshot (NaN/inf/negative histogram or device load)
        must not poison the EWMAs the controller plans from."""
        return bool(np.isfinite(pop).all() and (pop >= 0).all()
                    and np.isfinite(load).all() and (load >= 0).all())

    # --- feeding ------------------------------------------------------------
    def observe_step(self, stats: List, n_tokens: int) -> None:
        """One engine micro-batch: ``stats`` is the server's LayerStats list
        (may span multiple forwards), ``n_tokens`` the valid tokens served."""
        da = self.cfg.drift_alpha
        self.steps += 1
        for s in stats:
            lt = self._layers.get(s.layer)
            if lt is None:
                lt = self._layers[s.layer] = LayerTelemetry(
                    n_experts=int(np.asarray(s.actual_pop).shape[0]))
            pop = np.asarray(s.actual_pop, np.float64)
            load = np.asarray(s.device_load, np.float64)
            if not self._valid_obs(pop, load):
                self.record_error("telemetry_rejected")
                continue
            tot = pop.sum()
            if tot <= 0:          # all-padding micro-batch: nothing observed
                continue
            pop = pop / tot
            toks = getattr(s, "n_tokens", 0) or n_tokens
            w = min(1.0, toks / self.cfg.obs_tokens_ref) \
                if self.cfg.obs_tokens_ref else 1.0
            a = self.cfg.alpha * w
            if lt.popularity is None:
                lt.popularity = pop.copy()
                lt.popularity_var = np.zeros_like(pop)
                lt.popularity_slow = pop.copy()
            else:
                dev = pop - lt.popularity
                lt.popularity += a * dev
                # EWMA of per-batch share variance: how far a single
                # micro-batch swings each expert from its running mean —
                # the controller plans against mean + k*std (upper
                # envelope), its safety stock for sampling spikes
                lt.popularity_var += a * (dev * dev - lt.popularity_var)
                lt.popularity_slow += self.cfg.slow_alpha * w * \
                    (pop - lt.popularity_slow)
                # drift = the fast average pulling away from the slow one —
                # robust to single-batch spikes (a tiny decode batch barely
                # moves either EWMA), unlike comparing consecutive batches
                drifted = float(not top2k_sets_match(
                    lt.popularity, lt.popularity_slow, self.cfg.top_k))
                lt.drift_rate += da * (drifted - lt.drift_rate)
            lt._last_pop = pop
            load = np.asarray(s.device_load, np.float64)
            lt.load_max += a * (float(load.max()) - lt.load_max)
            lt.load_mean += a * (float(load.mean()) - lt.load_mean)
            rep = getattr(s, "replica_load", None)
            if rep is not None:
                rep = np.asarray(rep, np.float64)
                if rep.size and rep.sum() > 0:
                    lt.rep_max += a * (float(rep.max()) - lt.rep_max)
                    lt.rep_mean += a * (float(rep.mean()) - lt.rep_mean)
            lt.tokens += a * (float(toks) - lt.tokens)
            lt.steps += 1
            lt.finetunes += int(s.finetuned)
            lt.reuses += int(s.plan_reused)
            if self.metrics is not None:
                g = self.metrics.gauge
                lab = str(int(s.layer))
                g("sched_drift_rate", layer=lab).set(lt.drift_rate)
                g("sched_device_imbalance", layer=lab).set(lt.imbalance)
                g("sched_replica_imbalance",
                  layer=lab).set(lt.replica_imbalance)

    def observe_cache(self, stats) -> None:
        """Fold a PlanCacheStats snapshot into hit/miss/invalidation rates
        (EWMA over the deltas since the previous snapshot)."""
        if stats is None:
            return
        cur = (stats.hits, stats.misses, stats.invalidations)
        d = [max(0, c - l) for c, l in zip(cur, self._cache_last)]
        self._cache_last = cur
        total = d[0] + d[1]
        if total:
            a = self.cfg.alpha
            for key, val in zip(("hit", "miss", "invalidation"),
                                (d[0] / total, d[1] / total, d[2] / total)):
                self.cache_rates[key] += a * (val - self.cache_rates[key])
        if self.metrics is not None:
            for key, val in self.cache_rates.items():
                self.metrics.gauge("sched_plan_cache_rate",
                                   outcome=key).set(val)

    # --- reading ------------------------------------------------------------
    def layers(self) -> List[int]:
        return sorted(self._layers)

    def layer(self, li: int) -> Optional[LayerTelemetry]:
        return self._layers.get(li)

    def popularity(self, li: int) -> Optional[np.ndarray]:
        lt = self._layers.get(li)
        return None if lt is None or lt.popularity is None \
            else lt.popularity / max(lt.popularity.sum(), 1e-12)

    def last_popularity(self, li: int) -> Optional[np.ndarray]:
        """The most recent single-batch histogram — spiky, but it is what
        the live plan is actually serving; the controller scores plan
        staleness against it."""
        lt = self._layers.get(li)
        return None if lt is None else lt._last_pop

    def popularity_envelope(self, li: int, risk: float = 1.0
                            ) -> Optional[np.ndarray]:
        """mean + ``risk`` * std of each expert's per-batch share,
        renormalized — the upper envelope the controller sizes replicas
        against (straggler cost is a max, so width must cover what an
        expert *can* draw in one batch, not just its average)."""
        lt = self._layers.get(li)
        if lt is None or lt.popularity is None:
            return None
        env = lt.popularity + risk * np.sqrt(np.maximum(lt.popularity_var,
                                                        0.0))
        return env / max(env.sum(), 1e-12)

    def drift_rate(self, li: int) -> float:
        lt = self._layers.get(li)
        return 0.0 if lt is None else lt.drift_rate

    def snapshot(self) -> dict:
        """Host-side report (serve driver / benchmark JSON)."""
        return {
            "steps": self.steps,
            "cache_rates": dict(self.cache_rates),
            "errors": dict(self.errors),
            "layers": {
                li: {
                    "drift_rate": lt.drift_rate,
                    "imbalance": lt.imbalance,
                    "replica_imbalance": lt.replica_imbalance,
                    "tokens_ewma": lt.tokens,
                    "a2a_bytes_max": lt.a2a_bytes(self.cfg.bytes_per_token),
                    "observations": lt.steps,
                    "finetunes": lt.finetunes,
                    "plan_reuses": lt.reuses,
                } for li, lt in sorted(self._layers.items())
            },
        }
