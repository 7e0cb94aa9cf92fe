"""The port's expert-parallel MoE layer (``core.moe.moe_layer`` with a
``mesh``) on 8 spawned gloo ranks, a (2, 4) ``(data, model)`` mesh,
against the reference's ``moe_layer`` on an 8-device CPU mesh.

Each port rank gets the reference's shard of x, as its ``bspec`` lays it
out: batch slice d, sequence slice m.  The cases (``_torch_ranks.MOE_CASES``)
cover ``lina`` True / False, ``n_microops`` 1, 2 and 3 (3 resolves to 2
of the local capacity 8), gelu / swiglu, top-1 / 2, ``fsdp`` and
``shortcut_params``; ``kernel_route`` runs the port's kernel route (the
kernels' plain versions on the CPU) against the reference's einsum route.
Expert ids are held exactly, y within 1e-5, aux within 1e-6.

Gradients of sum(y * ct) come from ``jax.grad`` of the reference layer on
the mesh, which runs under the installed JAX.  The port's are assembled
from the ranks: x by slice, the replicated router and shortcut weights
summed over the ranks, an expert's weights summed over the data-parallel
ranks that hold it (with ``fsdp``, each rank's hidden slice as it is).
Held within 1e-5 (absolute, on gradients of order 1).

The reference runs once (module-scoped subprocess with
``--xla_force_host_platform_device_count=8``, all cases, an ``.npz``),
and so do the port's ranks.

Lina's pipelined backward against one exchange, on (1, 4) and (2, 4)
meshes (``_torch_ranks.lina_body``, the kernel route): ``lina`` with 4
micro-ops, and with 3 (which does not divide the local capacity 8 and
resolves to 2), against ``lina=False``, gelu and swiglu, y and every
gradient within rtol / atol 1e-6.  The capacity is a multiple of 8, so
no request resolves to 3 through the layer: the expert-parallel section
alone takes a buffer of capacity 6, where 4 micro-ops resolve to 3
(its weight gradients, of order 5, within 1e-6 of their largest
magnitude).
A row of y, dx and the router's gradient is the row's own, so these are
bitwise wherever the plain matmul's rows do not depend on M
(``rows_stable``, probed on the ranks); the expert weights' gradients
sum the rows in another order (chunk-major against source-major), so
they are held within the tolerance only.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import (MOE_CASES, SECTION_MICROOPS, lina_body, moe_body,
                          run_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, EP = 2, 4
E, D, F = 8, 16, 32
Y_ATOL, AUX_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5

REF = """
import sys, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.core.moe import MoEParams, moe_layer
from repro.launch.mesh import mesh_context
inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for name, (lina, nmo, ffn, k, fsdp, sc, _) in cases.items():
    cfg = MoEConfig(n_experts=8, top_k=k, d_ff=32, n_microops=nmo,
                    compute_backend="xla")
    params = MoEParams(inp["router"], inp["wi"],
                       inp["wu"] if ffn == "swiglu" else None, inp["wo"])
    scp = (inp["sc_in"], inp["sc_up"], inp["sc_out"]) if sc else None

    def run(x, p, s):
        return moe_layer(mesh, x, p, cfg, ffn_type=ffn, lina=lina,
                         fsdp=fsdp, shortcut_params=s)

    def loss(x, p, s):
        return jnp.sum(run(x, p, s).y * inp["ct"])
    with mesh_context(mesh):
        o = jax.jit(run)(inp["x"], params, scp)
        gx, gp, gs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            inp["x"], params, scp)
    out[name + "/y"] = np.asarray(o.y)
    out[name + "/aux"] = np.asarray(o.aux_loss)
    out[name + "/eidx"] = np.asarray(o.expert_idx)
    out[name + "/probs"] = np.asarray(o.router_probs)
    out[name + "/gx"] = np.asarray(gx)
    for f in MoEParams._fields:
        if getattr(gp, f) is not None:
            out[name + "/g" + f] = np.asarray(getattr(gp, f))
    if sc:
        for i, g in enumerate(gs):
            out[name + f"/gsc{i}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.RandomState(0)

    def w(*shape):
        return (rng.randn(*shape) * shape[-2] ** -0.5).astype(np.float32)
    inp = {"x": rng.randn(8, 8, D).astype(np.float32),
           "ct": rng.randn(8, 8, D).astype(np.float32),
           "router": w(D, E), "wi": w(E, D, F), "wu": w(E, D, F),
           "wo": w(E, F, D), "sc_in": w(D, F), "sc_up": w(D, F),
           "sc_out": w(F, D)}
    np.savez(tmp / "inp.npz", **inp)
    import json
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF),
                        str(tmp / "inp.npz"), str(tmp / "ref.npz"),
                        json.dumps(MOE_CASES)],
                       env=env, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    got = run_ranks(moe_body, DP * EP, tmp, str(tmp / "inp.npz"), (DP, EP),
                    list(MOE_CASES))
    return dict(np.load(tmp / "ref.npz")), got


def _assemble(got, name, key):
    """[8, 8, ...] from the ranks' (batch, sequence) slices."""
    b, s = 8 // DP, 8 // EP
    parts = [g[name][key] for g in got]
    out = np.zeros((8, 8) + parts[0].shape[2:], parts[0].dtype)
    for r, p in enumerate(parts):
        d, m = divmod(r, EP)
        out[d * b:(d + 1) * b, m * s:(m + 1) * s] = p
    return out


def _flat(got, name, key):
    """Token-flat outputs in the reference's (data, model) shard order."""
    return np.concatenate([g[name][key] for g in got])


def _expert_grad(got, name, field, fsdp):
    """The whole model's gradient of an expert weight from the ranks."""
    el = E // EP
    parts = [g[name]["grads"][field] for g in got]
    full = np.zeros((E,) + ((D, F) if field != "wo" else (F, D)),
                    np.float32)
    for r, p in enumerate(parts):
        d, m = divmod(r, EP)
        if not fsdp:
            full[m * el:(m + 1) * el] += p
            continue
        h = p.shape[-1] if field != "wo" else p.shape[-2]
        if field == "wo":
            full[m * el:(m + 1) * el, d * h:(d + 1) * h] = p
        else:
            full[m * el:(m + 1) * el, :, d * h:(d + 1) * h] = p
    return full


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_layer_matches_reference_on_a_2x4_mesh(runs, name):
    want, got = runs
    lina, nmo, ffn, k, fsdp, sc, _ = MOE_CASES[name]
    np.testing.assert_array_equal(_flat(got, name, "eidx"),
                                  want[name + "/eidx"])
    np.testing.assert_allclose(_assemble(got, name, "y"), want[name + "/y"],
                               atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(_flat(got, name, "probs"),
                               want[name + "/probs"], atol=1e-6, rtol=0)
    auxes = {g[name]["aux"] for g in got}
    assert len(auxes) == 1               # the mean over every rank
    assert auxes.pop() == pytest.approx(float(want[name + "/aux"]),
                                        abs=AUX_ATOL)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_layer_gradients_match_reference_on_a_2x4_mesh(runs, name):
    want, got = runs
    lina, nmo, ffn, k, fsdp, sc, _ = MOE_CASES[name]
    np.testing.assert_allclose(_assemble(got, name, "gx"),
                               want[name + "/gx"], atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(
        sum(g[name]["grads"]["router"] for g in got), want[name + "/grouter"],
        atol=GRAD_ATOL, rtol=0)
    fields = ("wi", "wu", "wo") if ffn == "swiglu" else ("wi", "wo")
    for f in fields:
        np.testing.assert_allclose(_expert_grad(got, name, f, fsdp),
                                   want[name + "/g" + f], atol=GRAD_ATOL,
                                   rtol=0, err_msg=f)
    if sc:
        for i in range(3):
            np.testing.assert_allclose(
                sum(g[name]["gsc"][i] for g in got), want[name + f"/gsc{i}"],
                atol=GRAD_ATOL, rtol=0, err_msg=f"shortcut {i}")


LINA_SHAPES = [(1, 4), (2, 4)]
LINA_CASES = [("gelu", 4), ("swiglu", 4), ("gelu", 3), ("swiglu", 3)]
LINA_TOL = 1e-6
SECTION_C = 6


@pytest.fixture(scope="module")
def lina_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lina")
    rng = np.random.RandomState(1)

    def w(*shape):
        return (rng.randn(*shape) * shape[-2] ** -0.5).astype(np.float32)
    inp = {"x": rng.randn(8, 8, D).astype(np.float32),
           "ct": rng.randn(8, 8, D).astype(np.float32),
           "router": w(D, E), "wi": w(E, D, F), "wu": w(E, D, F),
           "wo": w(E, F, D),
           "sec": rng.randn(DP * EP, E, SECTION_C, D).astype(np.float32),
           "ct_sec": rng.randn(DP * EP, E, SECTION_C, D).astype(
               np.float32)}
    np.savez(tmp / "inp.npz", **inp)
    return {shape: run_ranks(lina_body, shape[0] * shape[1], tmp,
                             str(tmp / "inp.npz"), shape, LINA_CASES, "sec")
            for shape in LINA_SHAPES}


def _held(got, want, bitwise, what, scaled=False):
    """Each pair bitwise, or within LINA_TOL (``scaled``: of the largest
    magnitude of ``want``)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if bitwise[i]:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} [{i}]")
        elif scaled:
            assert np.abs(a - b).max() <= LINA_TOL * np.abs(b).max(), \
                f"{what} [{i}]"
        else:
            np.testing.assert_allclose(a, b, rtol=LINA_TOL, atol=LINA_TOL,
                                       err_msg=f"{what} [{i}]")


@pytest.mark.parametrize("ffn,nmo", LINA_CASES)
@pytest.mark.parametrize("shape", LINA_SHAPES, ids=["1x4", "2x4"])
def test_pipelined_backward_matches_one_exchange_on_gloo_ranks(
        lina_runs, shape, ffn, nmo):
    got = lina_runs[shape]
    assert {g["n_layer"][nmo] for g in got} == {4 if nmo == 4 else 2}
    stable = all(g["rows_stable"] for g in got)
    fields = ("router", "wi", "wu", "wo") if ffn == "swiglu" \
        else ("router", "wi", "wo")
    for r, g in enumerate(got):
        lina, one = g[ffn, nmo][True], g[ffn, nmo][False]
        np.testing.assert_array_equal(lina["eidx"], one["eidx"])
        tensors = [(lina[k], one[k]) for k in ("y", "gx")] + \
            [(lina["grads"][f], one["grads"][f]) for f in fields]
        # y, dx and the router's gradient row by row; the experts' sums
        # over rows in another order
        bitwise = [stable] * 3 + [False] * (len(fields) - 1)
        _held(*zip(*tensors), bitwise, f"rank {r} {ffn} {nmo}")


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
@pytest.mark.parametrize("shape", LINA_SHAPES, ids=["1x4", "2x4"])
def test_section_pipelines_a_chunk_count_resolved_to_3(lina_runs, shape,
                                                       ffn):
    got = lina_runs[shape]
    assert {g["n_section"] for g in got} == {3}
    stable = all(g["rows_stable"] for g in got)
    for r, g in enumerate(got):
        lina, one = g["section", ffn, SECTION_MICROOPS], g["section", ffn, 1]
        # y and dx row by row; the weights' sums over rows, of order 5
        # here (unit inputs and cotangent), held to LINA_TOL of their scale
        bitwise = [stable] * 2 + [False] * (len(lina) - 2)
        _held(lina, one, bitwise, f"rank {r} {ffn} section", scaled=True)
