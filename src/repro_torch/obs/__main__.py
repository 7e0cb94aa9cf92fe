"""Trace/metrics artifact validator of the serving stack's exports.

    PYTHONPATH=src python -m repro_torch.obs validate --trace-dir obs_out \
        [--ttft-tol 1e-6] [--require-requests 1]

Checks, against the artifact set ``ObsContext.export`` writes:

  * ``spans.json``: every span closed, children inside their parent,
    sequential children sum <= parent duration (``check_span_tree``);
  * every completed ``request`` span's TTFT decomposition:
    ``ttft_s == queue + prefill + insert`` within tolerance, read from the
    span's phase children AND its stamped attributes;
  * ``trace.json`` (Chrome trace_event): rebuilds the span trees from the
    exported artifact and re-verifies the request decomposition on it —
    the file an operator actually opens in Perfetto is the file we gate;
  * ``metrics.prom`` parses, and the admission ledger closes:
    offered == completed + shed when the engine drained.

Exit code 0 = clean; 2 = violations (printed one per line).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.tracer import (Span, check_span_tree, spans_from_json,
                              tree_from_chrome)


def check_request_ttft(spans: List[Span], tol: float) -> List[str]:
    """TTFT = queue + prefill + insert, per completed generating request.
    Checked two ways: phase-child durations, and the stamped attrs."""
    errs = []
    n_checked = 0
    for root in spans:
        if root.name != "request" or "ttft_s" not in root.attrs:
            continue
        phases = {}
        for c in root.children:
            if c.name in ("queued", "prefill", "insert"):
                phases[c.name] = phases.get(c.name, 0.0) + c.duration
        if set(phases) != {"queued", "prefill", "insert"}:
            errs.append(f"request rid={root.attrs.get('rid')}: missing "
                        f"TTFT phases (have {sorted(phases)})")
            continue
        n_checked += 1
        ttft = float(root.attrs["ttft_s"])
        csum = sum(phases.values())
        if abs(csum - ttft) > tol:
            errs.append(
                f"request rid={root.attrs.get('rid')}: ttft {ttft:.9f}s != "
                f"queued+prefill+insert {csum:.9f}s (|d|="
                f"{abs(csum - ttft):.3e} > {tol:.1e})")
        asum = sum(float(root.attrs.get(k, 0.0))
                   for k in ("queue_s", "prefill_s", "insert_s"))
        if abs(asum - ttft) > tol:
            errs.append(f"request rid={root.attrs.get('rid')}: attr "
                        f"breakdown {asum:.9f}s != ttft {ttft:.9f}s")
    return errs, n_checked


def check_ledger(samples: dict) -> List[str]:
    """offered == completed + shed, read back through the metrics view
    (only meaningful after the engine drained — which the exporting
    drivers guarantee)."""
    offered = samples.get("engine_requests_offered_total")
    if offered is None:
        return []
    completed = samples.get("engine_requests_completed_total", 0.0)
    shed = sum(v for k, v in samples.items()
               if k.startswith("engine_requests_shed_total"))
    if abs(offered - (completed + shed)) > 1e-9:
        return [f"admission ledger leak: offered={offered} != "
                f"completed={completed} + shed={shed}"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="check exported trace artifacts")
    v.add_argument("--trace-dir", required=True,
                   help="directory written by ObsContext.export")
    v.add_argument("--ttft-tol", type=float, default=1e-6,
                   help="absolute tolerance (s) for the TTFT decomposition")
    v.add_argument("--require-requests", type=int, default=0,
                   help="fail unless at least N request spans were checked")
    args = ap.parse_args(argv)

    errs: List[str] = []
    spans_path = os.path.join(args.trace_dir, "spans.json")
    with open(spans_path) as f:
        spans = spans_from_json(json.load(f))
    errs += check_span_tree(spans, abs_tol=args.ttft_tol)
    ttft_errs, n_req = check_request_ttft(spans, args.ttft_tol)
    errs += ttft_errs

    chrome_path = os.path.join(args.trace_dir, "trace.json")
    n_chrome = 0
    if os.path.exists(chrome_path):
        with open(chrome_path) as f:
            chrome = tree_from_chrome(json.load(f))
        # µs-granular round-trip: loosen only by the serialization noise
        c_errs, n_chrome = check_request_ttft(chrome,
                                              args.ttft_tol + 1e-5)
        errs += c_errs
    else:
        errs.append(f"missing {chrome_path}")

    prom_path = os.path.join(args.trace_dir, "metrics.prom")
    if os.path.exists(prom_path):
        with open(prom_path) as f:
            samples = parse_prometheus(f.read())
        errs += check_ledger(samples)
    else:
        errs.append(f"missing {prom_path}")

    if n_req < args.require_requests:
        errs.append(f"only {n_req} request spans checked "
                    f"(need >= {args.require_requests})")
    for e in errs:
        print(f"VIOLATION: {e}")
    print(f"checked {sum(1 for _ in spans)} root spans, {n_req} request "
          f"TTFT decompositions (+{n_chrome} via Chrome round-trip): "
          f"{'FAIL' if errs else 'OK'}")
    return 2 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
