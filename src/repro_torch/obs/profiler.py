"""Device-time attribution: ``torch.profiler`` sessions + overlap-phase
replay.

Two pieces, as in the reference's ``repro.obs.profiler``:

  * ``trace_session`` / ``StepProfiler`` — a ``torch.profiler`` capture
    around a window of steps.  With a card present it records CUDA activity
    beside the host's, and a failure to start raises: the reference's guard
    (a no-op where its TensorBoard plugin is missing) has no counterpart
    here, so a capture on the card is never silently empty.  On a machine
    without a card it records host activity only.  ``kernel_times()`` sums
    the captured device time by kernel name; with a ``logdir`` the capture
    is also written there as a Chrome trace.

  * ``attribute_overlap`` / ``hidden_fraction`` — replay overlap
    micro-benchmark rows into a span tree so that "fraction of the a2a
    hidden" is recomputable from the trace (the reference's functions,
    verbatim).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from repro_torch.obs.tracer import Span, Tracer

__all__ = ["trace_session", "StepProfiler", "attribute_overlap",
           "hidden_fraction"]


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
        self.active = True
        return self

    def __exit__(self, *exc):
        if not self.active:
            return False
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
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


class StepProfiler:
    """Start a capture at step ``start`` and stop it after ``steps``
    profiled steps — "skip the warm-up, profile a window".  Drive it with
    ``on_step(step_idx)`` from any loop."""

    def __init__(self, logdir: Optional[str] = None, start: int = 2,
                 steps: int = 3, enabled: bool = True):
        self.start = int(start)
        self.stop_at = int(start) + int(steps)
        self._session = trace_session(logdir, enabled=enabled)
        self._started = False

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
        if self._session.active and step >= self.stop_at:
            self._session.__exit__()

    def close(self) -> None:
        self._session.__exit__()

    def kernel_times(self) -> Dict[str, float]:
        return self._session.kernel_times()


def attribute_overlap(tracer: Tracer, rows, t0: float = 0.0) -> List:
    """Replay overlap-microbench rows into spans.

    Each row (a dict with ``variant``, ``chunks_requested``,
    ``chunks_chosen``, ``us_per_call``, ``serial_us``, ``a2a_us``,
    ``a2a_hidden_frac`` — the schema of ``BENCH_schedules.json``'s
    ``overlap`` key) becomes one root span with three sequential phase
    children::

        overlap/<variant>-c<requested>
          ├─ serial      (pipeline-off baseline, serial_us)
          ├─ a2a_only    (chunked dispatch+combine with identity expert)
          └─ pipelined   (the overlapped variant, us_per_call)

    Spans are laid out back-to-back from ``t0`` on a microsecond-scaled
    timeline.  Returns the created root spans (empty when disabled)."""
    roots = []
    cursor = float(t0)
    for row in rows:
        ser = float(row["serial_us"]) * 1e-6
        a2a = float(row["a2a_us"]) * 1e-6
        pipe = float(row["us_per_call"]) * 1e-6
        name = (f"overlap/{row['variant']}"
                f"-c{row.get('chunks_requested', '?')}")
        root = tracer.add(name, cursor, cursor + ser + a2a + pipe,
                          **{k: row[k] for k in
                             ("mode", "variant", "chunks_requested",
                              "chunks_chosen", "a2a_hidden_frac")
                             if k in row})
        t = cursor
        root.child("serial", t, t + ser)
        t += ser
        root.child("a2a_only", t, t + a2a)
        t += a2a
        root.child("pipelined", t, t + pipe)
        cursor += ser + a2a + pipe
        roots.append(root)
    return roots


def hidden_fraction(span: Span) -> float:
    """Recompute the overlap efficiency from an attribution span's phase
    children: ``(serial - pipelined) / a2a_only``, clipped to [0, 1] —
    the same formula ``benchmarks.train_side`` measures, but sourced from
    the (possibly Chrome-round-tripped) trace."""
    dur = {}
    for c in span.children:
        dur[c.name] = c.duration
    a2a = dur.get("a2a_only", 0.0)
    if a2a <= 0:
        return 0.0
    frac = (dur.get("serial", 0.0) - dur.get("pipelined", 0.0)) / a2a
    return max(0.0, min(1.0, frac))
