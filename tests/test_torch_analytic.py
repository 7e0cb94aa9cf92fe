"""The port's launch arithmetic against the reference's: the analytic
FLOP / byte model (``launch/analytic.py``) for every registry config at
the four shapes, bit for bit, and the collective byte conventions
(``launch/hlo_analysis.py``'s ``wire_bytes``) for the five ops.  The
reference's ``launch/dryrun.py`` is not imported (it sets XLA_FLAGS when
imported): ``roofline_terms`` is held to its formula."""
from __future__ import annotations

import pytest

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import SHAPES as J_SHAPES
from repro.launch.analytic import analytic_cost as j_analytic_cost
from repro.launch.hlo_analysis import wire_bytes as j_wire_bytes
from repro_torch.configs import H100, REGISTRY, SHAPES
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.dryrun import roofline_terms
from repro_torch.launch.hlo_analysis import collective_summary, wire_bytes
from repro_torch.launch.mesh import Record

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_analytic_cost_is_the_references(arch, shape):
    got = analytic_cost(REGISTRY[arch], SHAPES[shape])
    want = j_analytic_cost(J_REGISTRY[arch], J_SHAPES[shape])
    assert got.flops_global == want.flops_global
    assert got.hbm_bytes_global == want.hbm_bytes_global
    assert got.matmul_params == want.matmul_params
    assert got.notes == want.notes


def test_the_registry_has_the_references_fourteen_configs():
    assert sorted(REGISTRY) == sorted(J_REGISTRY) and len(REGISTRY) == 14


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_are_the_references(op, n):
    for size in (0, 2, 4096, 3 * 2**30 + 6):
        assert wire_bytes(op, size, n) == j_wire_bytes(op, size, n)


def test_collective_summary_of_records_by_hand():
    recs = [Record("all-to-all", "model", 4, "bfloat16", 1000),
            Record("all-to-all", "model", 4, "bfloat16", 1000),
            Record("all-reduce", "world", 8, "float32", 800),
            Record("all-gather", "data", 2, "float32", 64),
            Record("reduce-scatter", "data", 2, "float32", 32),
            Record("barrier", "world", 8, "none", 0),
            Record("all-reduce", "data", 1, "float32", 4096)]
    s = collective_summary(recs)
    assert s["counts"] == {"all-to-all": 2, "all-reduce": 2,
                           "all-gather": 1, "reduce-scatter": 1}
    assert s["wire_bytes"] == {"all-to-all": 1500.0, "all-reduce": 1400.0,
                               "all-gather": 32.0, "reduce-scatter": 32.0}
    assert s["raw_bytes"]["all-reduce"] == 4896
    assert s["total_wire_bytes"] == 2964.0
    assert s["total_raw_bytes"] == 2000 + 4896 + 64 + 32


def test_roofline_terms_are_the_references_formula_on_the_h100():
    t = roofline_terms(3e15, 2e12, 5e9, 256)
    assert t["compute_s"] == 3e15 / (256 * 989e12)
    assert t["memory_s"] == 2e12 / (256 * 3.35e12)
    assert t["collective_s"] == 5e9 / (1 * 450e9)
    assert t["collective_s_single_link"] == 5e9 / 450e9
    assert roofline_terms(1.0, 1.0, 1.0, 1, hw=H100) == roofline_terms(
        1.0, 1.0, 1.0, 1)
