"""Finding model + baseline workflow for the static contract checker (a
copy of the reference's ``src/repro/analysis/findings.py``).

A finding is identified by a *fingerprint* — ``category:module:qualname:key``
— that deliberately excludes line numbers and byte counts, so reformatting a
file or nudging a block size does not churn the baseline.  CI compares the
current findings against the committed baseline (the port's is
``src/repro_torch/analysis/baseline.json``) and fails
only on fingerprints not present there: known ceilings stay tracked (and
visible in the report) without blocking the build, while any *new* contract
violation does.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Finding:
    category: str          # e.g. "refused-shape", "unbound-axis"
    module: str            # repo-relative path, e.g. "src/repro_torch/kernels/dispatch.py"
    qualname: str          # enclosing function / kernel entry point
    key: str               # stable discriminator (block name, shape case, ...)
    message: str           # human-readable, with the computed numbers
    severity: str = "error"      # "error" | "warning"
    lineno: int | None = None    # informational only — not fingerprinted
    data: dict = dataclasses.field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        return f"{self.category}:{self.module}:{self.qualname}:{self.key}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def sort_findings(findings: list[Finding]) -> list[Finding]:
    return sorted(findings, key=lambda f: (f.category, f.module,
                                           f.qualname, f.key))


def report_dict(findings: list[Finding], *, budget: int | None = None) -> dict:
    """``budget``: a block's shared-memory limit the kernel pass held the
    kernels to (bytes)."""
    by_cat: dict[str, int] = {}
    for f in findings:
        by_cat[f.category] = by_cat.get(f.category, 0) + 1
    return {
        "version": 1,
        "smem_budget_bytes": budget,
        "counts": dict(sorted(by_cat.items())),
        "findings": [f.to_dict() for f in sort_findings(findings)],
    }


def write_baseline(path: str, findings: list[Finding]) -> None:
    """Baseline = the fingerprint set (plus messages for readability)."""
    payload = {
        "version": 1,
        "fingerprints": {f.fingerprint: f.message
                         for f in sort_findings(findings)},
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> set[str]:
    with open(path) as fh:
        payload = json.load(fh)
    return set(payload.get("fingerprints", {}))


def new_findings(findings: list[Finding], baseline: set[str]) -> list[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]
