"""Torch's CPU threads in a parallel test run.

Under ``pytest -n N`` (xdist) every worker runs torch with as many
intra-op threads as the machine has cores, so N workers oversubscribe the
cores N-fold, and torch's spinning OpenMP workers then stall one another:
a forward pass that takes 0.2 s alone took minutes beside three other
workers.  ``share_cores()`` gives each worker its share of the cores
(at least one thread); outside xdist it changes nothing.  Every xdist
worker imports every test module when it collects, so one call at import
sets its workers' threads for the whole run.  What a test computes does
not change beyond the order of its floating-point sums.
"""
from __future__ import annotations

import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()
