"""Pass 3 — the re-trace detector (the only runtime pass), the port's
counterpart of the reference's ``src/repro/analysis/retrace.py``.

Steady-state serving and training must not stall on a first-time cost.
On the TPU that is a jit re-trace; here it is an ``nvcc`` build or a
library load by ``kernels._build`` (a kernel source compiled or loaded for
the first time in the window) or, on the card, a new segment of the
caching allocator (a ``cudaMalloc``: a shape that the warmed-up pool does
not hold).  ``no_retrace()`` wraps a steady-state window and asserts that
none of them happened inside it.

Counting reads ``kernels._build.STATS`` (builds, loads) and, where CUDA is
initialised, ``torch.cuda.memory_stats()["segment.all.allocated"]`` on
the current device.  ``supported()`` is always True: the counters exist
on every device (the segment count only on the card).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels import _build


class RetraceError(AssertionError):
    pass


@dataclasses.dataclass
class RetraceReport:
    where: str
    allow: int = 0
    count: int | None = None     # None until the window closes
    builds: int = 0
    loads: int = 0
    segments: int | None = None  # None off the card

    @property
    def ok(self) -> bool:
        return self.count is None or self.count <= self.allow


def _segments():
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def supported() -> bool:
    return True


@contextlib.contextmanager
def no_retrace(where: str = "steady-state", *, allow: int = 0,
               strict: bool = True):
    """Context manager asserting no kernel build, library load or new
    allocator segment inside the window.

    Yields a RetraceReport; ``report.count`` (their sum) is filled when
    the window closes.  ``strict=False`` records without raising;
    ``allow`` tolerates a known number."""
    report = RetraceReport(where=where, allow=allow)
    b0, l0, s0 = _build.STATS["builds"], _build.STATS["loads"], _segments()
    yield report
    s1 = _segments()
    report.builds = _build.STATS["builds"] - b0
    report.loads = _build.STATS["loads"] - l0
    report.segments = None if s0 is None or s1 is None else s1 - s0
    report.count = report.builds + report.loads + (report.segments or 0)
    if strict and not report.ok:
        raise RetraceError(
            f"{report.count} first-time cost(s) during {where} (allowed "
            f"{allow}): {report.builds} kernel build(s), {report.loads} "
            f"library load(s), {report.segments} new allocator segment(s)")
