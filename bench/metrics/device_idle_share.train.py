"""The share of a step in which no operation runs on the device: one
less the device's busy time a captured step over the mean step time of
the run's own untraced window (the capture's own window is slowed by the
profiler's host overhead)."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["steps"] / rec["window_step_s"])
