"""Adaptive resource scheduling for serving (closes the §5 loop).

The static stack plans from a per-batch popularity estimate under a fixed
``max_pack`` replica cap.  This package turns that into a control loop:

  ``telemetry``  — per-layer metrics bus the serving path feeds every step
                   (EWMA expert popularity, drift rate, PlanCache hit /
                   invalidation rates, per-device load and modeled a2a
                   bytes);
  ``controller`` — telemetry-driven autoscaling of per-layer replica
                   counts and expert→device placement, with hysteresis and
                   a migration-cost model bounding plan churn;
  ``workloads``  — seeded, replayable request-trace generator (drifting
                   Zipf skew, flash crowds, diurnal shifts) that exercises
                   the controller under traffic the static benchmark
                   cannot express.

Plain numpy on the host, copies of the reference's ``repro.sched``
modules over the port's ``core.placement`` and ``core.popularity``: the
same traces, telemetry and controller decisions, bit for bit.
"""
from repro_torch.sched.controller import (AdaptiveScheduler,
                                          AutoscaleController,
                                          ControllerConfig, replica_targets)
from repro_torch.sched.telemetry import (LayerTelemetry, TelemetryBus,
                                         TelemetryConfig)
from repro_torch.sched.workloads import (SCENARIOS, TraceSpec,
                                         generate_trace, get_spec, get_trace)

__all__ = [
    "AdaptiveScheduler", "AutoscaleController", "ControllerConfig",
    "replica_targets", "LayerTelemetry", "TelemetryBus", "TelemetryConfig",
    "SCENARIOS", "TraceSpec", "generate_trace", "get_spec", "get_trace",
]
