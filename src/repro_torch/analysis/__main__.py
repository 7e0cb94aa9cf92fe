"""CLI of the port's static contract checker.

    PYTHONPATH=src python -m repro_torch.analysis \
        --baseline src/repro_torch/analysis/baseline.json --fail-on-new \
        [--report analysis_report.json]

Exit codes (the reference's): 0 clean / only-baseline findings; 2 with
``--fail-on-new`` when findings outside the baseline exist OR when
baseline entries are stale (fingerprints no longer produced: a fixed
finding is removed from the baseline, so that it only shrinks
deliberately).  ``--write-baseline`` accepts the current findings as the
new baseline (review the diff before committing it).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import (load_baseline, new_findings, report_dict,
                                  run_all, write_baseline)
from repro_torch.configs import H100


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", default=".",
                    help="repo root containing src/repro_torch")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON with the accepted fingerprints")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 2 when findings not in the baseline exist, "
                         "or when baseline entries have gone stale")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to --baseline and exit")
    ap.add_argument("--report", default=None,
                    help="write the full findings report (JSON) here")
    ap.add_argument("--scales", default="1,4",
                    help="comma-separated paper-shape divisors")
    args = ap.parse_args(argv)

    scales = tuple(int(s) for s in args.scales.split(","))
    findings = run_all(args.root, scales=scales)

    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report_dict(findings, budget=int(H100.vmem_bytes)),
                      fh, indent=2)
            fh.write("\n")

    if args.write_baseline:
        if not args.baseline:
            ap.error("--write-baseline requires --baseline")
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    fresh = new_findings(findings, baseline)
    fresh_fps = {x.fingerprint for x in fresh}
    known = len(findings) - len(fresh)
    stale = sorted(baseline - {f.fingerprint for f in findings})

    by_cat: dict = {}
    for f in findings:
        by_cat[f.category] = by_cat.get(f.category, 0) + 1
    print(f"repro_torch.analysis: {len(findings)} finding(s) "
          f"({known} baseline, {len(fresh)} new, {len(stale)} stale)  "
          f"{json.dumps(by_cat, sort_keys=True)}")
    for f in findings:
        mark = "NEW " if f.fingerprint in fresh_fps else "    "
        print(f"  {mark}[{f.severity:7s}] {f.fingerprint}")
        print(f"        {f.message}")
    for fp in stale:
        print(f"  STALE {fp}")
        print("        baseline entry no longer produced: the finding was "
              "fixed; remove it from the baseline")

    if args.fail_on_new and (fresh or stale):
        if fresh:
            print(f"FAIL: {len(fresh)} new finding(s) not in baseline",
                  file=sys.stderr)
        if stale:
            print(f"FAIL: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'}: shrink the "
                  f"baseline to match", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
