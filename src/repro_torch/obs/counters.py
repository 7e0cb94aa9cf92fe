"""In-program counts: totals the program adds on the device, inside a
``counting()`` block only.

``moe.routed_pairs`` counts the (token, choice) pairs ``core.moe.moe_layer``
routed (T x k, a host integer) and ``moe.kept_pairs`` those its experts'
capacity kept (the kept counts' sum, a device tensor: no host sync), so
``1 - kept / routed`` is the share of rows the layer dropped.  A forward
run inside a backward (the remat recompute) is not counted again.  The
block reads each total to the host once, at its exit.  Outside a block a
count site costs one check of a module flag: ``active()``.  One block at a
time a process (a second raises).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["COUNTS", "counting", "active", "add"]

COUNTS = ("moe.routed_pairs", "moe.kept_pairs")

_totals: Optional[dict] = None          # name -> int or device tensor


def active() -> bool:
    """True inside a ``counting()`` block, outside a backward."""
    return _totals is not None and torch._C._current_graph_task_id() == -1


def add(name: str, value) -> None:
    """Add ``value`` (a host integer or a device tensor) to ``name``'s
    total; call only where ``active()``."""
    if name not in COUNTS:
        raise ValueError(f"{name!r} is not a count of obs.COUNTS")
    _totals[name] = _totals.get(name, 0) + value


class counting:
    """``with counting() as c:`` ... ``c.totals`` ({name: int}) after the
    block; the counts no site added are absent."""

    def __init__(self):
        self.totals: Dict[str, int] = {}

    def __enter__(self) -> "counting":
        global _totals
        if _totals is not None:
            raise RuntimeError("a counting block is open already")
        _totals = {}
        return self

    def __exit__(self, *exc):
        global _totals
        got, _totals = _totals, None
        self.totals = {k: int(v) for k, v in got.items()}
        return False
