"""Deterministic fault schedules and the injector that replays them.

A ``FaultSchedule`` is a seeded, immutable list of ``Fault`` events keyed by
ENGINE STEP (not wall time — virtual-clock replay must reproduce bitwise).
``FaultInjector.attach`` hooks a schedule into a ``ServingEngine``:

  device_failure   the device stops computing: a fail-slow model multiplies
                   the step's modeled service time by ``magnitude`` scaled
                   by the token share the realized routing still lands on
                   it.  With resilience on, the failure is also REPORTED
                   (``scheduler.fail_devices`` / ``server.fail_devices``)
                   so the degradation ladder re-routes around it; naive
                   serving keeps routing into the failure and eats the
                   latency forever.
  straggler        same fail-slow model, but transient (``duration`` steps)
                   and never reported — the controller must see it through
                   telemetry, not an oracle.
  telemetry        the scheduler's view of the step's LayerStats is
                   corrupted (NaN popularity) while active; the bus's
                   validation (always-on) rejects the poisoned snapshots.
  planner_crash    the server's plan builds raise while active
                   (``MoEServer.fault_hook``); the watchdog ladder
                   (always-on) falls back instead of failing the batch.
  overload         ``n_requests`` synthetic requests are submitted in one
                   burst at the step's start; admission control (opt-in)
                   degrades the burst to explicit sheds/rejections.

Every random draw comes from ``np.random.RandomState(seed)`` — the same
seed replays the same faults against every engine variant, which is what
makes the chaos benchmark's degradation-on vs naive columns comparable.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("device_failure", "straggler", "telemetry", "planner_crash",
               "overload")


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int                  # engine step the fault starts at (1-indexed:
    #                            engine.step_idx increments before firing)
    duration: int = 1          # steps the fault stays active; -1 = permanent
    device: int = -1           # device_failure / straggler target
    layer: int = -1            # telemetry target layer (-1 = all layers)
    magnitude: float = 4.0     # fail-slow service-time multiplier
    n_requests: int = 0        # overload burst size

    def active_at(self, step: int) -> bool:
        if step < self.step:
            return False
        return self.duration < 0 or step < self.step + self.duration


class FaultSchedule:
    """Immutable step-keyed fault list (sorted by start step)."""

    def __init__(self, faults):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, f.kind, f.device)))

    def starting(self, step: int) -> List[Fault]:
        return [f for f in self.faults if f.step == step]

    def ending(self, step: int) -> List[Fault]:
        """Faults whose last active step was ``step - 1``."""
        return [f for f in self.faults
                if f.duration > 0 and f.step + f.duration == step]

    def active(self, step: int, kind: Optional[str] = None) -> List[Fault]:
        return [f for f in self.faults if f.active_at(step)
                and (kind is None or f.kind == kind)]

    def __len__(self) -> int:
        return len(self.faults)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultSchedule) and \
            self.faults == other.faults

    def __repr__(self) -> str:
        return f"FaultSchedule({list(self.faults)!r})"


def single_device_failure(step: int, device: int, duration: int = -1,
                          magnitude: float = 4.0) -> FaultSchedule:
    """The chaos suite's headline scenario: one device dies (permanently by
    default) partway through the trace."""
    return FaultSchedule([Fault("device_failure", step, duration=duration,
                                device=device, magnitude=magnitude)])


def overload_burst(step: int, n_requests: int) -> FaultSchedule:
    return FaultSchedule([Fault("overload", step, n_requests=n_requests)])


def chaos_schedule(seed: int, n_steps: int, n_devices: int,
                   n_layers: int = 1, kinds=FAULT_KINDS,
                   n_faults: int = 4, max_duration: int = 8,
                   magnitude: float = 4.0,
                   burst_requests: int = 8) -> FaultSchedule:
    """Seeded random schedule: ``n_faults`` events drawn uniformly over
    ``kinds`` and steps [2, n_steps].  Deterministic — the same arguments
    always produce an identical schedule (the determinism test pins this).
    At most one device_failure is emitted (and never on device 0) so a
    short chaos run cannot mask every device."""
    rng = np.random.RandomState(seed)
    faults: List[Fault] = []
    emitted_death = False
    for _ in range(n_faults):
        kind = kinds[rng.randint(len(kinds))]
        if kind == "device_failure" and (emitted_death or n_devices < 2):
            kind = "straggler"
        step = int(rng.randint(2, max(n_steps, 3)))
        dur = int(rng.randint(1, max_duration + 1))
        if kind == "device_failure":
            emitted_death = True
            faults.append(Fault(kind, step, duration=-1,
                                device=int(rng.randint(1, n_devices)),
                                magnitude=magnitude))
        elif kind == "straggler":
            faults.append(Fault(kind, step, duration=dur,
                                device=int(rng.randint(0, max(n_devices, 1))),
                                magnitude=magnitude))
        elif kind == "telemetry":
            faults.append(Fault(kind, step, duration=dur,
                                layer=int(rng.randint(-1, n_layers))))
        elif kind == "planner_crash":
            faults.append(Fault(kind, step, duration=dur))
        else:                                      # overload
            faults.append(Fault(kind, step,
                                n_requests=int(rng.randint(
                                    1, burst_requests + 1))))
    return FaultSchedule(faults)


class PlannerCrash(RuntimeError):
    """The injected planner exception (distinguishable from real bugs)."""


class FaultInjector:
    """Replays a ``FaultSchedule`` into an attached engine.

    ``resilience`` selects the degradation contrast the chaos benchmark
    measures: with it ON, detected device failures are reported to the
    scheduler/server (device-masked replanning + zero-migration re-route);
    OFF is the naive baseline — the same faults fire, but the planner stays
    blind to device health and keeps routing into the failure.  The
    always-on rungs (telemetry validation, controller isolation, planner
    watchdog) act in both modes, because they have no off switch in the
    stack either.
    """

    def __init__(self, schedule: FaultSchedule, resilience: bool = True,
                 rng_seed: int = 0, vocab_size: int = 256,
                 burst_seq_len: int = 8, burst_max_new_tokens: int = 0):
        self.schedule = schedule
        self.resilience = resilience
        self.rng = np.random.RandomState(rng_seed)
        self.vocab_size = int(vocab_size)
        self.burst_seq_len = int(burst_seq_len)
        self.burst_max_new_tokens = int(burst_max_new_tokens)
        self.engine = None
        self.scheduler = None
        self.server = None
        self.step = 0
        self.dead: set = set()            # devices currently failed
        self.events: Dict[str, int] = {}  # fired-fault ledger by kind
        self.injected = 0                 # overload requests submitted
        self.injected_rejected = 0        # ... of which the queue refused
        self.injected_rids: set = set()   # rids of accepted burst requests
        self.penalty_log: List[Tuple[int, float]] = []  # (step, fail-slow
        #                                  multiplier the step actually paid)
        self.fault_steps: Dict[str, List[int]] = {}

    # --- wiring -------------------------------------------------------------
    def attach(self, engine, scheduler=None) -> "FaultInjector":
        """Hook into ``engine`` (and its scheduler/server): step callback,
        service-model wrap, planner fault hook."""
        self.engine = engine
        engine.fault_injector = self
        self.scheduler = scheduler if scheduler is not None \
            else getattr(engine, "scheduler", None)
        self.server = engine.server
        engine.service_model = self._wrap_service_model(engine.service_model)
        self.server.fault_hook = self._plan_hook
        return self

    # --- the per-step driver ------------------------------------------------
    def on_step(self, engine, now: float) -> None:
        """Called by ``ServingEngine.step`` before batch formation."""
        self.step = engine.step_idx
        for f in self.schedule.ending(self.step):
            if f.kind == "device_failure" and f.device in self.dead:
                self.dead.discard(f.device)
                if self.resilience:
                    self._report_revive({f.device})
            # stragglers just lapse; telemetry/planner gates key on active()
        for f in self.schedule.starting(self.step):
            self.events[f.kind] = self.events.get(f.kind, 0) + 1
            self.fault_steps.setdefault(f.kind, []).append(self.step)
            # the fired-fault ledger, mirrored into the operator registry
            obs = getattr(engine, "obs", None)
            if obs is not None:
                obs.metrics.counter("faults_injected_total",
                                    kind=f.kind).inc()
            if f.kind == "device_failure":
                self.dead.add(f.device)
                if self.resilience:
                    self._report_failure({f.device})
            elif f.kind == "overload":
                self._inject_burst(engine, f, now)

    def _report_failure(self, devs) -> None:
        if self.scheduler is not None and hasattr(self.scheduler,
                                                  "fail_devices"):
            self.scheduler.fail_devices(devs)
        elif self.server is not None:
            self.server.fail_devices(devs)

    def _report_revive(self, devs) -> None:
        if self.scheduler is not None and hasattr(self.scheduler,
                                                  "revive_devices"):
            self.scheduler.revive_devices(devs)
        elif self.server is not None:
            self.server.revive_devices(devs)

    def _inject_burst(self, engine, f: Fault, now: float) -> None:
        for _ in range(f.n_requests):
            toks = self.rng.randint(0, self.vocab_size,
                                    size=(self.burst_seq_len,))
            rid = engine.submit(toks, arrival=now,
                                max_new_tokens=self.burst_max_new_tokens)
            self.injected += 1
            if rid >= 0:
                self.injected_rids.add(rid)
            if rid < 0:
                # burst traffic does not retry: the rejection is final, and
                # recorded so the accounting invariant still closes
                self.injected_rejected += 1
                engine.record_shed(-1, now, now, "rejected")

    # --- fault surfaces -----------------------------------------------------
    def _plan_hook(self, what: str, layer: int) -> None:
        if self.schedule.active(self.step, "planner_crash"):
            raise PlannerCrash(f"injected planner crash ({what}, layer "
                               f"{layer}, step {self.step})")

    def filter_stats(self, stats: List) -> List:
        """Telemetry corruption: while a telemetry fault is active the
        scheduler sees NaN popularity for the targeted layer(s).  The
        serving math is untouched — only the control loop's view."""
        active = self.schedule.active(self.step, "telemetry")
        if not active:
            return stats
        layers = {f.layer for f in active}
        out = []
        for s in stats:
            if -1 in layers or s.layer in layers:
                out.append(dc_replace(
                    s, actual_pop=np.full_like(
                        np.asarray(s.actual_pop, np.float64), np.nan)))
            else:
                out.append(s)
        return out

    def _slow_devices(self) -> Dict[int, float]:
        """Currently slow/dead devices -> service-time multiplier."""
        slow: Dict[int, float] = {}
        for f in self.schedule.active(self.step, "straggler"):
            slow[f.device] = max(slow.get(f.device, 1.0), f.magnitude)
        for f in self.schedule.faults:
            if f.kind == "device_failure" and f.device in self.dead:
                slow[f.device] = max(slow.get(f.device, 1.0), f.magnitude)
        return slow

    def _wrap_service_model(self, base):
        """Fail-slow service model: the step's modeled time inflates by the
        token share the realized routing still lands on dead/straggling
        devices (share * (magnitude - 1)).  Degradation that actually moves
        load off the device earns its recovery here — the modeled penalty
        follows the realized per-device ``device_load``, not an oracle flag.
        Every step's multiplier lands on ``penalty_log``: 1.0 means the
        step paid nothing for the fault — the exact same-step fault-free
        counterfactual the chaos benchmark's recovery clock needs."""
        n_dev = self.server.n_dev if self.server is not None else 1

        def wrapped(stats, n_tokens):
            t = float(base(stats, n_tokens)) if base is not None else 0.0
            slow = self._slow_devices()
            if not slow or not stats:
                self.penalty_log.append((self.step, 1.0))
                return t
            pen = 1.0
            for s in stats:
                per_dev = np.asarray(s.device_load, np.float64).reshape(-1)
                if per_dev.size != n_dev:
                    continue
                tot = per_dev.sum()
                if tot <= 0:
                    continue
                for d, mag in slow.items():
                    if 0 <= d < n_dev:
                        share = per_dev[d] / tot
                        pen = max(pen, 1.0 + share * (mag - 1.0))
            self.penalty_log.append((self.step, pen))
            return t * pen

        return wrapped

    # --- reporting ----------------------------------------------------------
    def report(self) -> dict:
        return {
            "resilience": self.resilience,
            "events": dict(self.events),
            "fault_steps": {k: list(v) for k, v in self.fault_steps.items()},
            "dead_devices": sorted(self.dead),
            "injected_requests": self.injected,
            "injected_rejected": self.injected_rejected,
        }
