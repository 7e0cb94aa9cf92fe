"""Seeded fault injection + graceful-degradation glue.

``faults`` builds deterministic fault schedules and drives them into the
serving stack (``ServingEngine`` / ``AdaptiveScheduler`` / ``MoEServer``);
the degradation paths themselves live where they act — device-masked
planning in ``core.placement`` / ``core.serving``, the phase-2 watchdog and
emergency replanning in ``runtime.server``, admission control in
``runtime.engine``, exception isolation in ``sched``, the non-finite guard
in ``runtime.trainer``, checksummed checkpoints in ``checkpoint.manager``.
A plain-numpy copy of the reference's ``repro.resilience``.
"""
from repro_torch.resilience.faults import (FAULT_KINDS, Fault,
                                           FaultInjector, FaultSchedule,
                                           PlannerCrash, chaos_schedule,
                                           overload_burst,
                                           single_device_failure)

__all__ = ["FAULT_KINDS", "Fault", "FaultInjector", "FaultSchedule",
           "PlannerCrash", "chaos_schedule", "overload_burst",
           "single_device_failure"]
