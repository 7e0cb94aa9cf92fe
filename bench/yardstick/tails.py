"""Tail arithmetic of the serving cells: the linear-interpolation
percentile of ``repro_torch/runtime/engine.py::summarize_results``
(numpy's default), over every request due in the window.  A request
still unserved when the drain ends counts as failed and as later than
every served one: its latency is the larger of the time from its due
time to the end of the drain and the slowest served request's."""
from __future__ import annotations

import numpy as np


def latencies(due: list, done: dict, drain_end: float) -> np.ndarray:
    """Seconds from each due time to its first token; ``done`` maps a
    request's index to that time."""
    served = [done[i] - t for i, t in enumerate(due) if i in done]
    worst = max(served, default=0.0)
    return np.array([done[i] - t if i in done else
                     max(drain_end - t, worst) for i, t in enumerate(due)],
                    dtype=np.float64)


def percentile(values: np.ndarray, q: float) -> float:
    return float(np.percentile(values, q)) if values.size else float("nan")
