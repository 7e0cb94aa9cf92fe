"""Static contract checker of the port (``python -m repro_torch.analysis``),
the counterpart of the reference's ``repro.analysis``.

Three passes:

1. :mod:`repro_torch.analysis.kernels` — the launch contracts of the
   Hopper kernels: an AST inventory of the launch sites and C entries
   against a registry of the twelve kernels, each contract evaluated at
   the paper models' and the assigned configs' shapes, shared memory from
   the sources' constants, grid limits.
2. :mod:`repro_torch.analysis.collectives` — process-group contracts: axis
   names bound to :mod:`repro_torch.core.axes`, no axis string literals,
   no ``torch.distributed`` collective outside ``launch/mesh.py``, no
   all-to-all left unordered.
3. :mod:`repro_torch.analysis.retrace` — the runtime detector of
   first-time costs (kernel builds, library loads, allocator segments) in
   a steady-state window.

Passes 1-2 run against the committed baseline,
``src/repro_torch/analysis/baseline.json``: known findings stay visible
without failing; new ones (and stale baseline entries) fail.
"""
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           new_findings, report_dict,
                                           sort_findings, write_baseline)
from repro_torch.analysis.collectives import (analyze_collectives,
                                              canonical_axes)
from repro_torch.analysis.kernels import (REGISTRY, ShapeCase,
                                          analyze_kernels, build_cases,
                                          iter_c_entries, iter_launch_sites)
from repro_torch.analysis.retrace import (RetraceError, RetraceReport,
                                          no_retrace, supported)

__all__ = [
    "Finding", "load_baseline", "new_findings", "report_dict",
    "sort_findings", "write_baseline",
    "analyze_collectives", "canonical_axes",
    "REGISTRY", "ShapeCase", "analyze_kernels", "build_cases",
    "iter_c_entries", "iter_launch_sites",
    "RetraceError", "RetraceReport", "no_retrace", "supported",
    "run_all", "BASELINE",
]

BASELINE = "src/repro_torch/analysis/baseline.json"


def run_all(repo_root: str = ".", *, scales=(1, 4), cases=None) -> list:
    """Passes 1 + 2 over a repo checkout -> sorted findings."""
    import os
    findings = analyze_kernels(
        os.path.join(repo_root, "src", "repro_torch", "kernels"),
        scales=scales, cases=cases)
    findings += analyze_collectives(
        os.path.join(repo_root, "src", "repro_torch"))
    return sort_findings(findings)
