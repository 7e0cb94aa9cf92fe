"""A run with the timed path broken underneath comes out not correct: each
cell's run at the test size on the CPU (the look for a card skipped, the
rest of ``bench/run.py`` driven: the driver, the reference, the checks
against the cell's own limits, the result line), once sound and once for
each fault the cell can have (``bench/faults.py``)."""
import time

import pytest

from bench import faults as F
from bench import harness as H
from bench import run as R
from bench.smoke import smoke_cell

CELLS = {"gpt2-moe.train": ("unchanged_state", "half_batch"),
         "mixtral-8x22b.prefill": ("altered_token",)}
CASES = [(c, f) for c, fs in CELLS.items() for f in (None, *fs)]


def _result(name: str, fault):
    import importlib
    cell = smoke_cell(name, dtype="float32")
    driver = importlib.import_module(
        f"bench.drivers.{cell.workload['mode']}")
    seconds = 0.2 if cell.workload["mode"] == "serve" else 0.0
    if fault is None:
        out = driver.run(cell, 2**31 + 11, seconds, False, time.perf_counter(),
                         device="cpu")
    else:
        with F.planted(fault):
            out = driver.run(cell, 2**31 + 11, seconds, False,
                             time.perf_counter(), device="cpu")
    return R.assemble(H.manifest(), cell, out, False, "cpu test", 1)


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_fails_the_run(cell, fault):
    res = _result(cell, fault)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
