"""The port's a2a micro-ops (``repro_torch.core.microop``) on spawned gloo
ranks against the reference's on an 8-device CPU mesh.

The reference runs once, in a subprocess with
``--xla_force_host_platform_device_count=8`` (``REF`` below, module-scoped),
and saves its outputs to an ``.npz``; the port's ranks (``_torch_ranks``)
rendezvous through a file under ``tmp_path``.  Exchanges move values, so
they are held bitwise; ``resolve_chunk_count`` exactly over C 1-64 x
n 1-9.

The issue order of the MoE layer's pipeline, forward and backward, on a
(1, 4) ``MirrorMesh`` on the CPU: the mesh's timeline (``Mesh.mark``:
each exchange sent, waited for, returned, the tail) with the backward's
two halves and every wait logged into it.  In the backward dy's chunk
k+1 is sent before chunk k's dgrad and waited for after it, chunk k's
dx is returned before chunk k+1's dgrad, the weight gradients run after
the last dgrad and before the dx waits, and the last "a2a" mark follows
the last wait.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

from _torch_ranks import a2a_body, pipeline_body, run_ranks
from repro_torch.configs.base import MoEConfig
from repro_torch.core import microop
from repro_torch.core import moe as moe_mod
from repro_torch.core.microop import resolve_chunk_count
from repro_torch.core.moe import MoEParams, moe_layer
from repro_torch.launch.mesh import MirrorMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, C, D = 8, 6, 4

REF = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core import microop
inp = np.load(sys.argv[1])
E = inp["bufs8"].shape[1]
out = {"chunk_table": np.array([[microop.resolve_chunk_count(c, n)
                                 for n in range(1, 10)]
                                for c in range(1, 65)])}
fns = {
    "fwd": lambda b: microop.all_to_all_ec(b, "model"),
    "inv": lambda b: microop.all_to_all_ec_inverse(b, "model", E),
    "chunked": lambda b: jnp.concatenate(
        microop.chunked_all_to_all(b, "model", 3), 1),
    "ichunked": lambda b: jnp.concatenate(microop.chunked_all_to_all(
        b, "model", 4, inverse=True, n_experts=E), 1),
}
m8 = jax.make_mesh((1, 8), ("data", "model"))
m24 = jax.make_mesh((2, 4), ("data", "model"))
for name, fn in fns.items():
    f8 = shard_map(lambda b, fn=fn: fn(b[0])[None], mesh=m8,
                   in_specs=P("model"), out_specs=P("model"),
                   check_rep=False)
    out[name + "8"] = np.asarray(jax.jit(f8)(inp["bufs8"]))
    f24 = shard_map(lambda b, fn=fn: fn(b[0, 0])[None, None], mesh=m24,
                    in_specs=P("data", "model"),
                    out_specs=P("data", "model"), check_rep=False)
    out[name + "4"] = np.asarray(jax.jit(f24)(inp["bufs24"]))[0]
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("microop")
    rng = np.random.RandomState(0)
    inp = {"bufs8": rng.randn(8, E, C, D).astype(np.float32),
           "bufs24": rng.randn(2, 4, E, C, D).astype(np.float32),
           "cts8": rng.randn(8, E, C, D).astype(np.float32)}
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF),
                        str(tmp / "inp.npz"), str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return tmp, inp, dict(np.load(tmp / "ref.npz"))


def test_resolve_chunk_count_matches_reference(ref):
    _, _, want = ref
    got = np.array([[resolve_chunk_count(c, n) for n in range(1, 10)]
                    for c in range(1, 65)])
    np.testing.assert_array_equal(got, want["chunk_table"])


@pytest.mark.parametrize("world", [4, 8])
def test_a2a_matches_reference(ref, world, tmp_path):
    tmp, inp, want = ref
    if world == 8:
        np.savez(tmp_path / "bufs.npz", bufs=inp["bufs8"], cts=inp["cts8"])
    else:
        np.savez(tmp_path / "bufs.npz", bufs=inp["bufs24"][0],
                 cts=inp["cts8"][:4])
    got = run_ranks(a2a_body, world, tmp_path, str(tmp_path / "bufs.npz"),
                    (1, world))
    for name in ("fwd", "inv", "chunked", "ichunked"):
        np.testing.assert_array_equal(np.stack([g[name] for g in got]),
                                      want[f"{name}{world}"], err_msg=name)
    assert {g["n_chunked"] for g in got} == {3}
    assert {g["n_ichunked"] for g in got} == {3}     # 4 resolves to 3 of 6
    # the exchange's backward is the inverse exchange of the cotangent
    for g in got:
        np.testing.assert_array_equal(g["grad"], g["want_grad"])


def test_pipelined_ffn_equals_serial_across_chunk_counts(tmp_path):
    rng = np.random.RandomState(1)
    np.savez(tmp_path / "inp.npz",
             bufs=rng.randn(4, E, C, D).astype(np.float32),
             w=rng.randn(4, E // 4, D, D).astype(np.float32))
    counts = (1, 2, 3, 4)
    got = run_ranks(pipeline_body, 4, tmp_path, str(tmp_path / "inp.npz"),
                    counts)
    for g in got:
        for n in counts:
            out, calls, _ = g[n]
            np.testing.assert_allclose(out, g["serial"], rtol=1e-6,
                                       atol=1e-6, err_msg=f"n_chunks {n}")
            k = resolve_chunk_count(C, n)                # 4 -> 3 of C = 6
            assert calls == [(C // k, i * C // k) for i in range(k)]
        out, calls = g["no_pipeline"]
        np.testing.assert_array_equal(out, g["serial"])
        assert calls == [(C, 0)]
    # the shadow ran once a call, on this rank's own buffer
    rng = np.random.RandomState(1)
    bufs = rng.randn(4, E, C, D).astype(np.float32)
    for r, g in enumerate(got):
        assert g[2][2] == pytest.approx(float(bufs[r].sum()), rel=1e-5)


def _pipeline_order(n: int, backward: bool) -> list:
    """The timeline of one pipelined section of n chunks."""
    seq = ["send"]
    for k in range(n):
        if k + 1 < n:
            seq.append("send")
        seq += ["wait", "a2a"] + (["dgrad"] if backward else []) + ["return"]
    if backward:
        seq += ["tail", "wgrad"]
    return seq + ["wait", "a2a"] * n


@pytest.mark.parametrize("ffn,nmo,lina,n", [
    ("gelu", 4, True, 4), ("swiglu", 4, True, 4),
    ("gelu", 3, True, 2),              # 3 resolves to 2 of C 8
    ("gelu", 4, False, 1)])
def test_backward_issue_order(monkeypatch, ffn, nmo, lina, n):
    mesh = MirrorMesh((1, 4), device="cpu")
    log = mesh.timeline = []

    def logged(kind, fn):
        def run(*a, **kw):
            log.append((kind, None))
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(moe_mod, "ffn_dgrad",
                        logged("dgrad", moe_mod.ffn_dgrad))
    monkeypatch.setattr(moe_mod, "ffn_wgrad",
                        logged("wgrad", moe_mod.ffn_wgrad))
    monkeypatch.setattr(microop.Pending, "wait",
                        logged("wait", microop.Pending.wait))
    g = torch.Generator().manual_seed(0)
    d, e, f = 16, 8, 32
    x = torch.randn(4, 2, d, generator=g).requires_grad_()
    p = MoEParams(*(torch.randn(*s, generator=g).requires_grad_()
                    for s in ((d, e), (2, d, f))),
                  torch.randn(2, d, f, generator=g).requires_grad_()
                  if ffn == "swiglu" else None,
                  torch.randn(2, f, d, generator=g).requires_grad_())
    cfg = MoEConfig(n_experts=e, top_k=2, d_ff=f, n_microops=nmo)
    y = moe_layer(x, p, cfg, ffn_type=ffn, mesh=mesh, lina=lina).y
    assert [k for k, _ in log] == _pipeline_order(n, backward=False)
    log.clear()
    y.sum().backward()
    kinds = [k for k, _ in log]
    at = {k: [i for i, v in enumerate(kinds) if v == k]
          for k in ("send", "dgrad", "return", "wgrad", "wait", "a2a")}
    assert len(at["dgrad"]) == len(at["send"]) == len(at["return"]) == n
    for k in range(n - 1):
        assert at["send"][k + 1] < at["dgrad"][k]     # dy(k+1) before dgrad k
        assert at["wait"][k + 1] > at["dgrad"][k]     # ... waited for after it
        assert at["return"][k] < at["dgrad"][k + 1]   # dx(k) before dgrad k+1
    assert at["wgrad"] == [at["return"][-1] + 2]      # dx(n-1) sent, "tail"
    assert at["dgrad"][-1] < at["wgrad"][0]
    dx_waits = at["wait"][-n:]
    assert at["wgrad"][0] < dx_waits[0]               # before the dx waits
    assert at["a2a"][-1] > dx_waits[-1] and kinds[-1] == "a2a"
    assert kinds == _pipeline_order(n, backward=True)
