"""The port's gradient reduction (``repro_torch.optim.reduce``,
``optim.compression``) against the reference's numerics, and on 4 spawned
gloo ranks against the analytic mean.

The reference's ``ReduceConfig`` errors, ``n_chunks_for_bytes``,
``compress_int8_ef`` and bf16 cast run once in a subprocess (module
scoped, an ``.npz``).  On a (2, 2) mesh every rank's gradients differ
(``_torch_ranks.reduce_tree``: base + 0.25 (rank + 1) delta); for each of
the 5 schedules x 3 compressions the result must be the analytic one:
replicated leaves the mean over the 4 ranks, expert leaves the mean over
the data-parallel group divided by ep (``optim.reduce``'s derivation),
within 1e-5; bf16 within the reference test's 1e-2 of it (relative and
absolute); int8_ef the exact int8 arithmetic on the shared scale (the
ranks' maximum) within 1e-5, and the true mean within half a step of the
grid.  The partitioned schedules' chunk counts are the reference's
``n_chunks_for_bytes`` of each reduced part.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import reduce_body, reduce_tree, run_ranks
from repro_torch.optim import compression as C
from repro_torch.optim import reduce as R
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = R.SCHEDULES
COMPRESSIONS = (None, "bf16", "int8_ef")
PB = 512.0                     # bytes a micro-op: several chunks a part
WORLD, EP = 4, 2
EXPERT = [False, False, False, True, True]    # bias, dense, router, wi, wo

REF = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.optim import reduce as R
from repro.optim.compression import (compress_bf16, compress_int8_ef,
                                     Int8State)
inp = dict(np.load(sys.argv[1]))
out = {}
for i, kw in enumerate([dict(schedule="nope"),
                        dict(schedule="priority", compression="fp8")]):
    try:
        R.ReduceConfig(**kw)
        out[f"err{i}"] = np.array("")
    except ValueError as e:
        out[f"err{i}"] = np.array(str(e))
sizes = [[(24, 16)], [(40,), (24, 16), (16, 4)], [(2, 16, 8), (2, 8, 16)],
         [(1000, 1000)]]
for i, shapes in enumerate(sizes):
    for dt in ("float32", "bfloat16"):
        for pb in (1.0, 512.0, 30e6, 4e6):
            tree = [jnp.zeros(s, dt) for s in shapes]
            out[f"nc/{i}/{dt}/{pb}"] = np.array(R.n_chunks_for_bytes(tree, pb))
g = [inp["g0"], inp["g1"]]
r = [inp["r0"], inp["r1"]]
(qs, scales), st = compress_int8_ef(g, Int8State(r))
for i in range(2):
    out[f"q{i}"] = np.asarray(qs[i])
    out[f"s{i}"] = np.asarray(scales[i])
    out[f"e{i}"] = np.asarray(st.residual[i])
    out[f"b{i}"] = np.asarray(compress_bf16(g)[i].astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reduce")
    rng = np.random.RandomState(3)
    inp = {"g0": rng.randn(32, 8).astype(np.float32),
           "g1": (rng.randn(100) * 1e-3).astype(np.float32),
           "r0": (rng.randn(32, 8) * 1e-2).astype(np.float32),
           "r1": np.zeros(100, np.float32)}
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF),
                        str(tmp / "inp.npz"), str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return inp, dict(np.load(tmp / "ref.npz"))


def test_reduce_config_errors_match_reference(ref):
    _, want = ref
    for i, kw in enumerate([dict(schedule="nope"),
                            dict(schedule="priority", compression="fp8")]):
        with pytest.raises(ValueError) as e:
            R.ReduceConfig(**kw)
        assert str(e.value) == str(want[f"err{i}"])
    cfg = R.ReduceConfig("priority+partition")
    assert cfg.ordered and cfg.partitioned
    assert not R.ReduceConfig().ordered


def test_n_chunks_for_bytes_matches_reference(ref):
    _, want = ref
    sizes = [[(24, 16)], [(40,), (24, 16), (16, 4)],
             [(2, 16, 8), (2, 8, 16)], [(1000, 1000)]]
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, shapes in enumerate(sizes):
        for dt in dts:
            for pb in (1.0, 512.0, 30e6, 4e6):
                tree = tuple(torch.zeros(s, dtype=dts[dt]) for s in shapes)
                assert R.n_chunks_for_bytes(tree, pb) == \
                    int(want[f"nc/{i}/{dt}/{pb}"]), (i, dt, pb)


def test_int8_ef_and_bf16_match_reference_numerics(ref):
    inp, want = ref
    g = (torch.from_numpy(inp["g0"]), torch.from_numpy(inp["g1"]))
    r = (torch.from_numpy(inp["r0"]), torch.from_numpy(inp["r1"]))
    (qs, scales), st = C.compress_int8_ef(g, C.Int8State(r))
    for i in range(2):
        np.testing.assert_array_equal(qs[i].numpy(), want[f"q{i}"])
        np.testing.assert_allclose(float(scales[i]), float(want[f"s{i}"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(st.residual[i].numpy(), want[f"e{i}"],
                                   atol=1e-7, rtol=0)
        np.testing.assert_array_equal(
            C.compress_bf16(g)[i].float().numpy(), want[f"b{i}"])
    back = C.decompress_int8(qs, scales, like=g)
    np.testing.assert_allclose(back[0].numpy(),
                               want["q0"] * float(want["s0"]), rtol=1e-6)


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reduce_ranks")
    combos = [(s, c) for s in SCHEDULES for c in COMPRESSIONS]
    return run_ranks(reduce_body, WORLD, tmp, (2, 2), combos, PB)


def _analytic(comp):
    """Each rank's expected reduced leaves on the (2, 2) mesh."""
    leaves = [[l.numpy().astype(np.float64) for l in
               tree_leaves(reduce_tree(r))] for r in range(WORLD)]
    out = [[None] * len(EXPERT) for _ in range(WORLD)]
    for i, exp in enumerate(EXPERT):
        for r in range(WORLD):
            group = [m for m in range(WORLD) if m % EP == r % EP] if exp \
                else list(range(WORLD))
            vals = [leaves[q][i] for q in group]
            if comp == "int8_ef":
                scale = max(np.float32(np.abs(v).max()) / np.float32(127.0)
                            for v in vals)
                vals = [np.clip(np.round(v / scale), -127, 127) * scale
                        for v in vals]
            mean = sum(vals) / len(group)
            out[r][i] = mean / EP if exp else mean
    return leaves, out


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_reduce_gradients_gives_the_analytic_mean(reduced, sched, comp):
    leaves, want = _analytic(comp)
    _, exact = _analytic(None)
    for r, res in enumerate(reduced):
        got = res[(sched, comp)]
        for i, (g, w) in enumerate(zip(got["red"], want[r])):
            if comp == "bf16":
                np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                           err_msg=f"rank {r} leaf {i}")
            if comp == "int8_ef":       # within half a grid step of exact
                step = max(np.abs(v[i]).max() for v in leaves) / 127
                assert np.abs(g - exact[r][i]).max() <= 0.5 * step + 1e-6
        if comp != "int8_ef":           # async and sync agree bitwise
            for a, b in zip(got["again"], got["red"]):
                np.testing.assert_array_equal(a, b)
        else:                           # the residual is this rank's error
            res_l = got["residual"]
            assert len(res_l) == len(EXPERT)
            assert all(np.isfinite(x).all() for x in res_l)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_partitioned_schedules_use_the_reference_chunk_count(reduced, ref,
                                                             sched):
    _, want = ref
    plan = reduced[0][(sched, None)]["plan"]
    assert [idx for idx, _ in plan] == [[0, 1, 2], [3, 4]]
    # part 0 (bias, dense, router) and part 1 (wi, wo) are sizes 1 and 2 of
    # the reference's table
    ref_n = [int(want[f"nc/1/float32/{PB}"]), int(want[f"nc/2/float32/{PB}"])]
    if "partition" in sched:
        assert [n for _, n in plan] == ref_n and min(ref_n) > 1
    else:
        assert [n for _, n in plan] == [1, 1]


def test_int8_ef_requires_state():
    cfg = R.ReduceConfig("priority", compression="int8_ef")
    with pytest.raises(ValueError, match="needs a ReduceState"):
        R.reduce_gradients(None, {"a": torch.ones(3)}, cfg)
