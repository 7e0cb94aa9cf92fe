"""The control of ``correct`` at a size a test run holds: the reference put
in the program's place and computed below the configuration's bf16 (fp8,
as ``bench/calibrate.py`` reads it on the chip; in training judged on
its own expert choices, as the program is) comes out not correct
against the cell's own limits, while the
program on its plain route (in float32 at this size, where bf16's
relative rounding is coarser than at the cells' widths) comes out
correct."""
import numpy as np
import pytest

from bench import calibrate as C
from bench.drivers.serve import gap_numbers
from bench.smoke import smoke_cell


def _fails(numbers: dict, limits: dict) -> list:
    return [k for k in limits if numbers[k] > limits[k]]


@pytest.mark.parametrize("seed", [5, 2**31 + 6])
def test_training_control_fails(seed):
    cell = smoke_cell("gpt2-moe.train", dtype="float32")
    limits = cell.workload["limits"]
    row = C.train_seed(cell, seed, True, False, "cpu", precs=("fp8",))
    assert _fails(row["control_fp8"], limits)
    assert not _fails(row["program"], limits)


def test_serving_control_fails():
    cell = smoke_cell("mixtral-8x22b.prefill")
    cell.workload["check_requests"] = 48
    limits = cell.workload["limits"]
    row = C.serve_seed(cell, 6, 0.5, True, False, "cpu")
    assert _fails(gap_numbers(row["control"]), limits)
    assert not _fails(gap_numbers(row["program"]), limits)
    assert np.percentile(row["bf16_witness"], 90) <= limits["served_gap_p90"]
