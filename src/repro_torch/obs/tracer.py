"""Span-based tracing: the substrate for Lina's §3 attribution.

A ``Span`` is a named interval on a monotonic clock with attributes and
nested children.  Two usage modes share one tree:

  * context-manager spans (``tracer.span("phase1")``) nest via an explicit
    stack — the step/layer instrumentation in ``runtime.server`` and
    ``runtime.trainer``;
  * manual spans (``tracer.begin`` / ``Span.end_at`` / ``tracer.add``)
    carry explicit timestamps — request lifecycles that cross engine steps
    and live on the *virtual* clock during trace replay.

When the tracer is disabled every entry point returns the shared ``NOOP``
singleton: no ``Span`` is ever allocated, ``with tracer.span(...)`` costs
two no-op method calls, and the disabled fast path is what the 2%-overhead
guard in ``tests/test_obs.py`` measures.  ``tracer.timed`` is the one
always-measuring primitive (it replaces the ad-hoc ``time.perf_counter``
stopwatches the runtime used to carry): the elapsed ``dt`` is functional —
service-time stamps and the phase-2 watchdog depend on it — so it is
measured in both modes, and only the span recording is gated.

Exporters: ``to_json`` (lossless nested tree, what the invariant validator
consumes) and ``to_chrome`` (Chrome ``trace_event`` JSON — open in Perfetto
via ui.perfetto.dev or chrome://tracing; each root span tree gets its own
``tid`` so request lifecycles render as parallel tracks).
``tree_from_chrome`` rebuilds span trees from an exported Chrome trace, so
"TTFT = queue + prefill + insert" stays checkable on the artifact itself.

Ranges on the device clock: ``region(name)`` is a ``torch.profiler``
range while a profiler session records, and ``NOOP`` otherwise (one flag
check, nothing allocated).  The kernels launched under a range, and
those of the backward nodes its forward ops created, are its device time
(``obs.profiler.region_split``).  ``REGIONS`` names every range the
program opens: the train step's layers (``models.lm``: ``lm.cast``,
``lm.embed``, ``lm.stack``, ``lm.attention``, ``lm.moe``, ``lm.ffn``,
``lm.rwkv``, ``lm.hybrid``, ``lm.loss``; the layer ranges open again in
the remat recompute), its gradient reduction and update (``launch.steps``:
``optim.reduce``, ``optim.update``), and the names of the spans that an
enabled tracer's ``span`` and recording ``timed`` open (the trainer's
and the server's), each of which opens the range of its name too.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "Tracer", "NOOP", "REGIONS", "region", "to_json",
           "to_chrome", "tree_from_chrome", "check_span_tree"]

REGIONS = (
    # models.lm: the train step's layers
    "lm.cast", "lm.embed", "lm.stack", "lm.attention", "lm.moe", "lm.ffn",
    "lm.rwkv", "lm.hybrid", "lm.loss",
    # launch.steps: the gradient reduction over a mesh, clip and AdamW
    "optim.reduce", "optim.update",
    # runtime.trainer's spans
    "train.step", "data.batch", "fwd_bwd", "checkpoint",
    # runtime.server's spans
    "server.layer", "phase1.estimate", "plan.lookup", "plan.build",
    "phase2.finetune", "gate", "dispatch",
)
_REGION_SET = frozenset(REGIONS)


@dataclass
class Span:
    name: str
    start: float                                   # seconds (tracer clock)
    end: float = float("nan")                      # NaN while still open
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(self, name: str, start: float, end: float, **attrs) -> "Span":
        """Attach a completed child with explicit timestamps."""
        sp = Span(name, float(start), float(end), dict(attrs))
        self.children.append(sp)
        return sp

    def begin_child(self, name: str, start: float, **attrs) -> "Span":
        """Attach an open child (close it with ``end_at``)."""
        sp = Span(name, float(start), attrs=dict(attrs))
        self.children.append(sp)
        return sp

    def end_at(self, end: float, **attrs) -> "Span":
        self.end = float(end)
        self.attrs.update(attrs)
        return self

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]


class _Noop:
    """Disabled-path singleton: satisfies the full Span + context-manager
    API without allocating.  Every mutator returns ``self`` so chained
    instrumentation stays branch-free at call sites."""
    __slots__ = ()
    name = ""
    start = 0.0
    end = 0.0
    duration = 0.0
    attrs: Dict[str, Any] = {}
    children: List["Span"] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def child(self, name, start, end, **attrs):
        return self

    def begin_child(self, name, start, **attrs):
        return self

    def end_at(self, end, **attrs):
        return self

    def walk(self):
        return iter(())

    def find(self, name):
        return []


NOOP = _Noop()


def region(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler session records, else ``NOOP``.  ``name`` is one of
    ``REGIONS`` (a ValueError names any other, when a session records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOOP
    if name not in _REGION_SET:
        raise ValueError(f"{name!r} is not a range of obs.REGIONS")
    return torch.profiler.record_function(name)


class _ActiveSpan:
    """Context manager for stack-nested spans (enabled tracer only)."""
    __slots__ = ("_tracer", "span", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.span = Span(name, 0.0, attrs=attrs)
        self._range = region(name)

    def __enter__(self) -> Span:
        tr = self._tracer
        sp = self.span
        self._range.__enter__()
        sp.start = tr.clock()
        if tr._stack:
            tr._stack[-1].children.append(sp)
        else:
            tr._add_root(sp)
        tr._stack.append(sp)
        return sp

    def __exit__(self, *exc):
        tr = self._tracer
        sp = tr._stack.pop()
        sp.end = tr.clock()
        self._range.__exit__(*exc)
        return False


class _Timed:
    """Always-on stopwatch; records a span only when the tracer is enabled.
    Use where the measured ``dt`` is functional (service-time stamps, the
    phase-2 watchdog), so disabling tracing cannot change behavior.
    ``record=False`` keeps just the stopwatch — for call sites that lay
    their own explicit-timestamp spans out afterwards (engine step phases
    live on the virtual clock, not the wall clock being measured here)."""
    __slots__ = ("_tracer", "_name", "_attrs", "_record", "_range", "t0",
                 "dt")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 record: bool = True):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._record = record
        self._range = region(name) if record and tracer.enabled else NOOP
        self.t0 = 0.0
        self.dt = 0.0

    def __enter__(self) -> "_Timed":
        self._range.__enter__()
        self.t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        self.dt = tr.clock() - self.t0
        self._range.__exit__(*exc)
        if self._record and tr.enabled:
            tr.add(self._name, self.t0, self.t0 + self.dt, **self._attrs)
        return False


class Tracer:
    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 max_roots: int = 200_000):
        self.enabled = enabled
        self.clock = clock
        self.roots: List[Span] = []
        self.dropped_roots = 0        # no silent caps: overflow is counted
        self._stack: List[Span] = []
        self._max_roots = max_roots

    # --- recording ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Stack-nested span context manager (no-op when disabled); it
        opens the range ``region(name)`` too."""
        if not self.enabled:
            return NOOP
        return _ActiveSpan(self, name, attrs)

    def timed(self, name: str, record: bool = True, **attrs) -> _Timed:
        """Stopwatch that ALWAYS measures (``.dt`` after exit) and records
        a span only when enabled (and ``record`` is left on); then it
        opens the range ``region(name)`` too."""
        return _Timed(self, name, attrs, record=record)

    def begin(self, name: str, start: Optional[float] = None, **attrs):
        """Open a manual root span (explicit-timestamp mode; not stack
        nested).  Close with ``span.end_at(t)``."""
        if not self.enabled:
            return NOOP
        sp = Span(name, self.clock() if start is None else float(start),
                  attrs=dict(attrs))
        self._add_root(sp)
        return sp

    def add(self, name: str, start: float, end: float, **attrs):
        """Record a completed span with explicit timestamps — nested under
        the innermost open context-manager span if there is one, else as a
        new root."""
        if not self.enabled:
            return NOOP
        sp = Span(name, float(start), float(end), dict(attrs))
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self._add_root(sp)
        return sp

    def _add_root(self, sp: Span) -> None:
        if len(self.roots) >= self._max_roots:
            self.dropped_roots += 1
            return
        self.roots.append(sp)

    def clear(self) -> None:
        self.roots = []
        self._stack = []
        self.dropped_roots = 0


# --- exporters --------------------------------------------------------------
def _span_dict(sp: Span) -> dict:
    return {"name": sp.name, "start": sp.start, "end": sp.end,
            "attrs": sp.attrs,
            "children": [_span_dict(c) for c in sp.children]}


def _span_from_dict(d: dict) -> Span:
    sp = Span(d["name"], float(d["start"]), float(d["end"]),
              dict(d.get("attrs") or {}))
    sp.children = [_span_from_dict(c) for c in d.get("children", ())]
    return sp


def to_json(tracer: Tracer) -> dict:
    return {"dropped_roots": tracer.dropped_roots,
            "spans": [_span_dict(r) for r in tracer.roots]}


def spans_from_json(doc: dict) -> List[Span]:
    return [_span_from_dict(d) for d in doc.get("spans", ())]


def to_chrome(tracer: Tracer) -> dict:
    """Chrome ``trace_event`` format: complete ("X") events, µs
    timestamps rebased to the earliest span so virtual-clock and
    wall-clock trees share a viewable origin.  One ``tid`` per root tree
    keeps nesting unambiguous (Perfetto nests by containment per track)."""
    events = []
    t0 = min((r.start for r in tracer.roots), default=0.0)
    for tid, root in enumerate(tracer.roots):
        for sp in root.walk():
            end = sp.end if sp.end == sp.end else sp.start   # open: zero-dur
            events.append({
                "name": sp.name, "ph": "X", "pid": 0, "tid": tid,
                "ts": (sp.start - t0) * 1e6,
                "dur": max(0.0, (end - sp.start)) * 1e6,
                "args": {k: v for k, v in sp.attrs.items()},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def tree_from_chrome(doc: dict) -> List[Span]:
    """Rebuild span trees from a Chrome trace export (timestamps come back
    in seconds relative to the export origin).  Events on one ``tid`` nest
    by interval containment — exactly how ``to_chrome`` laid them out."""
    by_tid: Dict[Any, List[dict]] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "X":
            by_tid.setdefault(ev.get("tid", 0), []).append(ev)
    roots: List[Span] = []
    eps = 1e-9
    for tid in sorted(by_tid):
        evs = sorted(by_tid[tid], key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Span] = []
        for ev in evs:
            sp = Span(ev["name"], ev["ts"] * 1e-6,
                      (ev["ts"] + ev["dur"]) * 1e-6,
                      dict(ev.get("args") or {}))
            while stack and sp.start > stack[-1].end - eps:
                stack.pop()
            if stack:
                stack[-1].children.append(sp)
            else:
                roots.append(sp)
            stack.append(sp)
    return roots


def write_chrome(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(tracer), f)


# --- invariants -------------------------------------------------------------
def check_span_tree(spans: List[Span], rel_tol: float = 1e-6,
                    abs_tol: float = 1e-6) -> List[str]:
    """Structural invariants every exported trace must satisfy; returns a
    list of violation strings (empty = clean).

      * every span is closed and non-negative;
      * children lie inside their parent's interval;
      * the children of one span, being sequential phases, sum to at most
        the parent's duration.
    """
    errs: List[str] = []
    for root in spans:
        for sp in root.walk():
            if sp.end != sp.end:
                errs.append(f"open span: {sp.name}")
                continue
            if sp.end < sp.start - abs_tol:
                errs.append(f"negative span: {sp.name} "
                            f"({sp.start}..{sp.end})")
            csum = 0.0
            for c in sp.children:
                if c.start < sp.start - abs_tol or \
                        (c.end == c.end and c.end > sp.end + abs_tol):
                    errs.append(f"child {c.name} escapes parent {sp.name}")
                csum += max(0.0, c.duration)
            budget = sp.duration * (1.0 + rel_tol) + abs_tol
            if csum > budget:
                errs.append(f"children of {sp.name} sum to {csum:.9f}s > "
                            f"parent {sp.duration:.9f}s")
    return errs
