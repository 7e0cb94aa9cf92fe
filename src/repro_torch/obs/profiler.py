"""Device-time attribution: ``torch.profiler`` sessions, split by the
program's ranges.

  * ``trace_session`` / ``StepProfiler`` — a ``torch.profiler`` capture
    around a window of steps, inside an ``obs.counting()`` block (its
    totals in ``counts``).  With a card present it records CUDA activity
    beside the host's, and a failure to start raises: the reference's
    guard (a no-op where its TensorBoard plugin is missing) has no
    counterpart here, so a capture on the card is never silently empty.
    On a machine without a card it records host activity only.
    ``kernel_times()`` sums the captured device time by kernel name,
    ``region_split()`` by the program's range; with a ``logdir`` the
    capture is also written there as a Chrome trace.

  * ``region_split`` — each device kernel's time of a capture given to
    one range of ``obs.REGIONS``: the innermost range its launch lies in
    (the remat recompute included, which runs inside a backward node), or
    for a kernel of a backward node under no range, the range of the
    forward op that created the node (the node's ``sequence_nr`` and
    forward thread); any other kernel is unranged.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional

from repro_torch.obs.counters import counting
from repro_torch.obs.tracer import REGIONS

__all__ = ["trace_session", "StepProfiler", "attribution", "region_split"]

BACKWARD_NODE = "autograd::engine::evaluate_function: "
PHASES = ("forward", "recompute", "backward")


def attribution(events):
    """A function of a CPU event of ``events`` (``profile.events()``) ->
    (range, phase) that the kernels it launches go to, or None
    (unranged).  The phase is "forward", "recompute" (launched inside a
    range inside a backward node) or "backward" (inside a backward node
    and no range within it: the range of the forward op that created the
    node, by its ``sequence_nr`` and forward thread; for a node no forward
    op links, the next range or node above it)."""
    from torch.autograd import DeviceType
    regions = frozenset(REGIONS)
    memo = {}

    def context(e):
        """(the nearest range or backward node at or above e, whether a
        backward node lies at or above e)."""
        key = id(e)
        if key not in memo:
            up = (None, False) if e.cpu_parent is None \
                else context(e.cpu_parent)
            node = e.name.startswith(BACKWARD_NODE)
            memo[key] = (e if node or e.name in regions else up[0],
                         node or up[1])
        return memo[key]

    # (sequence_nr, thread) -> range or None.  Ops that create no node
    # carry the number the next node will take, so of the forward ops
    # with one key (in start order) the last is the node's creator.
    forward = {}
    for e in events:
        if e.device_type != DeviceType.CPU or e.sequence_nr < 0 or \
                e.name.startswith(BACKWARD_NODE):
            continue
        n, in_backward = context(e)
        if not in_backward:
            forward[(e.sequence_nr, e.thread)] = None if n is None \
                else n.name

    def of(e):
        n = context(e)[0]
        while n is not None:
            if n.name in regions:
                return n.name, "recompute" if context(n)[1] else "forward"
            name = forward.get((n.sequence_nr, n.fwd_thread))
            if name is not None:
                return name, "backward"
            # a node of a graph built inside a backward: the node it runs in
            n = None if n.cpu_parent is None else context(n.cpu_parent)[0]
        return None
    return of


def region_split(events) -> dict:
    """Device seconds of a capture's ``events`` by range
    (``attribution``): {"regions": {range: {phase: s}}, "unranged_s": s,
    "device_s": s}, ``device_s`` every device event's time (the ranges'
    own device annotations left out), ``unranged_s`` what no range
    claims."""
    from torch.autograd import DeviceType
    annotations = set(REGIONS) | {e.name for e in events
                                  if e.device_type == DeviceType.CPU
                                  and e.is_user_annotation}
    device_s = sum((e.time_range.end - e.time_range.start) / 1e6
                   for e in events if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.name not in annotations)
    of = attribution(events)
    split = defaultdict(lambda: dict.fromkeys(PHASES, 0.0))
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        ks = [k for k in e.kernels if k.name not in annotations]
        to = of(e) if ks else None
        if to is not None:
            split[to[0]][to[1]] += sum(k.duration for k in ks) / 1e6
    ranged = sum(sum(v.values()) for v in split.values())
    return {"regions": dict(split), "unranged_s": device_s - ranged,
            "device_s": device_s}


class trace_session:
    """Context manager around a ``torch.profiler.profile`` capture.
    ``active`` is True while it records; ``cuda`` says whether device
    activity is part of it (whenever ``torch.cuda.is_available()``)."""

    def __init__(self, logdir: Optional[str] = None, enabled: bool = True):
        self.logdir = logdir
        self.enabled = enabled
        self.active = False
        self.cuda = False
        self.prof = None
        self.path: Optional[str] = None
        self.counts: Dict[str, int] = {}
        self._count = None
        self._n = 0

    def __enter__(self) -> "trace_session":
        if not self.enabled or self.active:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._count = counting().__enter__()
        self.active = True
        return self

    def __exit__(self, *exc):
        if not self.active:
            return False
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self._count.__exit__(None, None, None)
        self.counts = self._count.totals
        self.active = False
        if self.logdir is not None:
            os.makedirs(self.logdir, exist_ok=True)
            self.path = os.path.join(self.logdir,
                                     f"profile_{self._n}.trace.json")
            self._n += 1
            self.prof.export_chrome_trace(self.path)
        return False

    def kernel_times(self) -> Dict[str, float]:
        """{kernel name: device microseconds summed over the capture} of the
        last finished capture, largest first (empty before one, and on a
        machine without a card)."""
        if self.prof is None or self.active:
            return {}
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        out = {e.key: e.self_device_time_total
               for e in self.prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def region_split(self) -> dict:
        """``region_split`` of the last finished capture (empty before
        one)."""
        if self.prof is None or self.active:
            return {}
        return region_split(self.prof.events())


class StepProfiler:
    """Start a capture at step ``start`` and stop it after ``steps``
    profiled steps — "skip the warm-up, profile a window".  Drive it with
    ``on_step(step_idx)`` from any loop, called after each step;
    ``captured`` counts the steps the capture holds."""

    def __init__(self, logdir: Optional[str] = None, start: int = 2,
                 steps: int = 3, enabled: bool = True):
        self.start = int(start)
        self.stop_at = int(start) + int(steps)
        self._session = trace_session(logdir, enabled=enabled)
        self._started = False
        self.captured = 0

    @property
    def active(self) -> bool:
        return self._session.active

    @property
    def session(self) -> trace_session:
        return self._session

    def on_step(self, step: int) -> None:
        if not self._started and step >= self.start:
            self._started = True
            self._session.__enter__()
        elif self._session.active:
            self.captured += 1
        if self._session.active and step >= self.stop_at:
            self._session.__exit__()

    def close(self) -> None:
        self._session.__exit__()

    def kernel_times(self) -> Dict[str, float]:
        return self._session.kernel_times()
