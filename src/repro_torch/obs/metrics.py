"""Counters / gauges / fixed-bucket histograms with Prometheus + JSON export.

The operator-facing half of ``repro.obs``: subsystems register named,
labeled metrics into one ``MetricsRegistry`` (the scheduling-policy view
stays on ``sched.TelemetryBus`` — EWMAs the controller plans from; this
registry is the monotonic/queryable view an operator scrapes).

Histograms never retain samples: observations land in fixed log-spaced
buckets (defaults cover 100ns..1000s at ~19% spacing — 4 buckets per
octave), and quantiles are read back by cumulative walk with log-linear
interpolation inside the landing bucket, so p50/p95/p99 are accurate to
bucket resolution on any stream length at O(n_buckets) memory.

``to_prometheus`` emits the text exposition format (counters as
``_total``-style samples, histograms as cumulative ``_bucket{le=...}`` +
``_sum``/``_count``); ``parse_prometheus`` reads it back sample-for-sample
— the round-trip the test suite pins.
"""
from __future__ import annotations

import math
import re
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_buckets", "parse_prometheus"]


def default_buckets(lo: float = 1e-7, hi: float = 1e3,
                    per_octave: int = 4) -> Tuple[float, ...]:
    """Log-spaced upper bounds from ``lo`` to >= ``hi``: ``per_octave``
    buckets per factor-of-two (4/octave ~= 19% relative resolution)."""
    step = 2.0 ** (1.0 / per_octave)
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * step)
    return tuple(bounds)


_DEFAULT_BUCKETS = default_buckets()


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + (+Inf) overflow.
    No sample retention; quantiles via log-linear interpolation."""
    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None):
        self.bounds = tuple(bounds) if bounds is not None \
            else _DEFAULT_BUCKETS
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """q in [0, 1]; NaN when empty.  Interpolates log-linearly inside
        the landing bucket (buckets are log-spaced), clamping to the
        bucket's bounds — never off by more than one bucket width."""
        if not self.count:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                frac = min(1.0, max(0.0, (rank - seen) / c))
                if i >= len(self.bounds):          # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i else hi / 2.0
                if lo <= 0:
                    return hi * frac
                return math.exp(math.log(lo) +
                                frac * (math.log(hi) - math.log(lo)))
            seen += c
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


def _fmt_float(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    return format(v, ".17g")


class MetricsRegistry:
    """Get-or-create registry keyed by (name, sorted labels).  One metric
    name has one type; mixing types under a name raises."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._types: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: dict, **kw):
        prev = self._types.get(name)
        if prev is None:
            self._types[name] = kind
        elif prev != kind:
            raise TypeError(f"metric {name!r} already registered as {prev}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = _METRIC_TYPES[kind](**kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, buckets: Optional[Tuple[float, ...]]
                  = None, **labels) -> Histogram:
        kw = {} if buckets is None else {"bounds": buckets}
        return self._get("histogram", name, labels, **kw)

    # --- reading ------------------------------------------------------------
    def get(self, name: str, **labels):
        """Existing metric or None (read-only view; no create)."""
        return self._metrics.get((name, _label_key(labels)))

    def value(self, name: str, **labels) -> float:
        m = self.get(name, **labels)
        return 0.0 if m is None else getattr(m, "value", float("nan"))

    def series(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], object]:
        """All (labels -> metric) rows registered under ``name``."""
        return {lk: m for (n, lk), m in self._metrics.items() if n == name}

    def to_json(self) -> dict:
        out: dict = {}
        for (name, lk), m in sorted(self._metrics.items()):
            row: dict = {"labels": dict(lk), "type": self._types[name]}
            if isinstance(m, Histogram):
                row.update(count=m.count, sum=m.sum,
                           p50=m.quantile(0.50), p95=m.quantile(0.95),
                           p99=m.quantile(0.99),
                           buckets={_fmt_float(b): c for b, c in
                                    zip(m.bounds + (math.inf,), m.counts)})
            else:
                row["value"] = m.value
            out.setdefault(name, []).append(row)
        return out

    def to_samples(self) -> Dict[str, float]:
        """Flat Prometheus-shaped samples: ``name{labels}`` -> value.
        Histograms expand to cumulative ``_bucket{le=}`` + _sum/_count —
        exactly what ``parse_prometheus(to_prometheus())`` returns."""
        samples: Dict[str, float] = {}
        for (name, lk), m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.bounds + (math.inf,), m.counts):
                    cum += c
                    key = _fmt_labels(tuple(sorted(
                        lk + (("le", _fmt_float(b)),))))
                    samples[f"{name}_bucket{key}"] = float(cum)
                samples[f"{name}_sum{_fmt_labels(lk)}"] = m.sum
                samples[f"{name}_count{_fmt_labels(lk)}"] = float(m.count)
            else:
                samples[f"{name}{_fmt_labels(lk)}"] = float(m.value)
        return samples

    def to_prometheus(self) -> str:
        lines: List[str] = []
        seen_type: set = set()
        for (name, lk), m in sorted(self._metrics.items()):
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {self._types[name]}")
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.bounds + (math.inf,), m.counts):
                    cum += c
                    key = _fmt_labels(tuple(sorted(
                        lk + (("le", _fmt_float(b)),))))
                    lines.append(f"{name}_bucket{key} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(lk)} "
                             f"{_fmt_float(m.sum)}")
                lines.append(f"{name}_count{_fmt_labels(lk)} {m.count}")
            else:
                lines.append(f"{name}{_fmt_labels(lk)} "
                             f"{_fmt_float(m.value)}")
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)'
    r'(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> Dict[str, float]:
    """Text exposition -> ``name{sorted labels}`` -> float.  Labels are
    re-sorted so the keys match ``MetricsRegistry.to_samples`` regardless
    of emission order."""
    samples: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        labels = _LABEL_RE.findall(m.group("labels") or "")
        key = m.group("name") + _fmt_labels(tuple(sorted(labels)))
        raw = m.group("value")
        samples[key] = float("inf") if raw == "+Inf" else float(raw)
    return samples
