"""The collective inventory of one step: the port's counterpart of the
reference's ``src/repro/launch/hlo_analysis.py``, under the same name so
that a reader finds it.

The reference parses a compiled HLO module and multiplies each
collective inside a while loop by the loop's trip count.  The port runs
eagerly: every layer is issued, so every collective it makes is one
``launch.mesh.Record`` of the mesh's recorder (``Mesh.records``, a
``RecordingMesh`` in the dry run) and no trip-count correction is
needed.  ``collective_summary`` takes those records and returns the
reference's keys.

Byte conventions (per rank, 'wire bytes' on a ring), the reference's:
    all-reduce          2 * size * (n-1)/n
    all-gather          out_size * (n-1)/n      (each rank receives the rest)
    reduce-scatter      in_size  * (n-1)/n
    all-to-all          size * (n-1)/n
    broadcast           size * (n-1)/n          (each rank but the root
                                                 receives it)
    collective-permute  size
``size`` is the byte size of the collective's result (``Record.nbytes``:
the gathered tensor of an all-gather, this rank's block of a
reduce-scatter), n the group's size.  A barrier moves no bytes.
"""
from __future__ import annotations

from collections import defaultdict

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "broadcast", "collective-permute")


def wire_bytes(op: str, size: int, n: int) -> float:
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * size * f
    if op == "all-gather":
        return size * f                  # size = gathered result
    if op == "reduce-scatter":
        return size * n * f        # size = scattered result; input n*size
    if op in ("all-to-all", "broadcast"):
        return size * f
    return float(size)                   # collective-permute


def collective_summary(records) -> dict:
    """``records`` (``launch.mesh.Record``s, in issue order) -> the
    reference's summary: wire and raw bytes and counts by kind and their
    totals."""
    totals = defaultdict(float)
    raw = defaultdict(float)
    counts = defaultdict(int)
    for r in records:
        if r.kind == "barrier":
            continue
        totals[r.kind] += wire_bytes(r.kind, r.nbytes, r.group_size)
        raw[r.kind] += r.nbytes
        counts[r.kind] += 1
    return {
        "entry": "eager",
        "wire_bytes": dict(totals),
        "raw_bytes": dict(raw),
        "counts": dict(counts),
        "total_wire_bytes": float(sum(totals.values())),
        "total_raw_bytes": float(sum(raw.values())),
    }
