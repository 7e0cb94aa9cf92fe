"""Tracing + metrics for the port's serving and training stacks.

``tracer`` (nested spans with JSON + Chrome ``trace_event`` export) and
``metrics`` (counters / gauges / histograms with Prometheus + JSON export)
are copies of the reference's.  ``region(name)`` is a ``torch.profiler``
range while a session records (else ``NOOP``), at the layer boundaries of
the train step; ``REGIONS`` lists every name the program opens (the
Tracer's spans open the range of their name too).  ``counting()`` holds
the program's device-side counts (``COUNTS``: ``moe.routed_pairs``,
``moe.kept_pairs``) for the life of a block.  ``profiler`` captures
device time with ``torch.profiler`` inside a counting block and splits
it by range (``region_split``).  ``ObsContext`` bundles one tracer and
one registry, shared by ``MoEServer`` and ``ServingEngine``.
``python -m repro_torch.obs validate`` checks an exported trace against
the span-tree invariants.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.obs.counters import COUNTS, counting
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, parse_prometheus)
from repro_torch.obs.profiler import (StepProfiler, region_split,
                                      trace_session)
from repro_torch.obs.tracer import (NOOP, REGIONS, Span, Tracer,
                                    check_span_tree, region, to_chrome,
                                    to_json, tree_from_chrome)

__all__ = [
    "ObsContext", "Tracer", "Span", "NOOP", "REGIONS", "region", "COUNTS",
    "counting", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "parse_prometheus", "to_json", "to_chrome", "tree_from_chrome",
    "check_span_tree", "trace_session", "StepProfiler", "region_split",
]


@dataclass
class ObsContext:
    """One tracer + one metrics registry, shared across a subsystem stack.
    Metrics are always live; span recording is opt-in."""
    tracer: Tracer
    metrics: MetricsRegistry

    @classmethod
    def disabled(cls) -> "ObsContext":
        """Tracing off (no-op spans), metrics on — the default wiring."""
        return cls(Tracer(enabled=False), MetricsRegistry())

    @classmethod
    def enabled(cls, clock=None) -> "ObsContext":
        tr = Tracer(enabled=True) if clock is None \
            else Tracer(enabled=True, clock=clock)
        return cls(tr, MetricsRegistry())

    def export(self, out_dir: str) -> dict:
        """Write ``trace.json`` (Chrome trace_event), ``spans.json`` (nested
        tree), ``metrics.prom`` + ``metrics.json`` under ``out_dir``.
        Returns {artifact name: path}."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        p = os.path.join(out_dir, "trace.json")
        with open(p, "w") as f:
            json.dump(to_chrome(self.tracer), f)
        paths["trace"] = p
        p = os.path.join(out_dir, "spans.json")
        with open(p, "w") as f:
            json.dump(to_json(self.tracer), f)
        paths["spans"] = p
        p = os.path.join(out_dir, "metrics.prom")
        with open(p, "w") as f:
            f.write(self.metrics.to_prometheus())
        paths["prom"] = p
        p = os.path.join(out_dir, "metrics.json")
        with open(p, "w") as f:
            json.dump(self.metrics.to_json(), f, indent=1)
        paths["metrics"] = p
        return paths
