"""The backward of the two recurrences on the CPU: ``ref_rwkv6_bwd`` and
``ref_ssd_bwd`` (the plain versions the backward kernels are held against
on the card) against torch autograd of the port's forward recurrences and
against ``jax.grad`` of the reference's oracles (``kernels/ref.py``
``ref_rwkv6`` / ``ref_ssd``) and model functions (``models/rwkv.py``
``wkv_chunked``, ``models/ssm.py`` ``ssd_chunked``); and ``rwkv6_op`` /
``ssd_op`` as differentiable ops.

Inputs come from seeded numpy; T = 1, 17, 64 and 100 at B = 1, and 64 at
B = 2, with a random non-zero bonus u, and with an initial state and a
final-state cotangent where the function takes them.  Every gradient is
held norm-wise within 1e-5 at float32 (the sums run in other orders).

The reference's ``ssd_chunked`` has no finite gradient at the model's own
decays (A = e^{a_log} up to 16, chunk 16): it forms exp(L_t - L_s) above
the diagonal, where it overflows, and masks it afterwards, so the
backward multiplies inf by 0.  ``test_reference_chunked_ssd_gradient_
is_nan_where_the_port_is_finite`` records that; the port's gradient is
held to ``jax.grad`` of the naive ``ref_ssd`` there instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.kernels import COUNTERS, ref, reset_counters
from repro_torch.kernels.ops import rwkv6_op, ssd_op
from repro_torch.kernels.rwkv6 import rwkv6_wkv_bwd
from repro_torch.kernels.ssd import ssd_scan_bwd

REL = 1e-5
H, HD = 2, 8                   # WKV heads x head dim
SH, SP, SN = 3, 8, 4           # SSD heads, P, N
CASES = [(1, 1), (1, 17), (1, 64), (1, 100), (2, 64)]   # (B, T)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def assert_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        assert np.isfinite(g).all(), name
        assert g.shape == np.shape(w), (name, g.shape, np.shape(w))
        assert rel(g, w) <= REL, (name, rel(g, w))


def wkv_inputs(b, t, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, H, HD)).astype(np.float32) * 0.5
               for _ in range(3))
    w = -np.exp(rng.standard_normal((b, t, H, HD)).astype(np.float32) * 0.5
                - 1.0)
    u = rng.standard_normal((H, HD)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((b, H, HD, HD)).astype(np.float32)
    dy = rng.standard_normal((b, t, H, HD)).astype(np.float32)
    ds_t = rng.standard_normal((b, H, HD, HD)).astype(np.float32)
    return r, k, v, w, u, s0, dy, ds_t


def ssd_inputs(b, t, seed=0, sliced=False):
    """x, dt, a_log, B, C, D, h0, dy, dh_T; the model's decays (a_log =
    log linspace(1, 16, H), dt ~ N(0, 1)).  With ``sliced`` x, B and C are
    strided slices of one [B, T, H P + 2 N] projection."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((b, t, SH * SP + 2 * SN)).astype(np.float32)
    dt = rng.standard_normal((b, t, SH)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, SH)).astype(np.float32)
    d = rng.standard_normal(SH).astype(np.float32)
    h0 = rng.standard_normal((b, SH, SP, SN)).astype(np.float32)
    dy = rng.standard_normal((b, t, SH, SP)).astype(np.float32)
    dh_t = rng.standard_normal((b, SH, SP, SN)).astype(np.float32)
    if sliced:
        full = torch.tensor(xbc)
        x = full[..., :SH * SP].reshape(b, t, SH, SP)
        bb, cc = full[..., SH * SP:SH * SP + SN], full[..., SH * SP + SN:]
    else:
        x = torch.tensor(np.ascontiguousarray(
            xbc[..., :SH * SP].reshape(b, t, SH, SP)))
        bb = torch.tensor(np.ascontiguousarray(xbc[..., SH * SP:SH * SP + SN]))
        cc = torch.tensor(np.ascontiguousarray(xbc[..., SH * SP + SN:]))
    return (x, torch.tensor(dt), torch.tensor(a_log), bb, cc, torch.tensor(d),
            torch.tensor(h0), torch.tensor(dy), torch.tensor(dh_t))


def autograd(fn, inputs, cotangents):
    xs = [a.detach().clone().requires_grad_() for a in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("b,t", CASES)
def test_wkv_bwd_matches_autograd(b, t):
    """With s0 and a final-state cotangent: every gradient, ds0 included."""
    r, k, v, w, u, s0, dy, ds_t = (torch.tensor(a) for a in wkv_inputs(b, t))
    got = ref.ref_rwkv6_bwd(r, k, v, w, u, s0, dy, ds_t)
    want = autograd(lambda *a: ref.ref_rwkv6(*a[:5], s0=a[5],
                                             return_state=True),
                    (r, k, v, w, u, s0), (dy, ds_t))
    assert_grads(got, want, ("dr", "dk", "dv", "dw", "du", "ds0"))


@pytest.mark.parametrize("b,t", CASES)
def test_wkv_bwd_matches_jax_oracle(b, t):
    """Against jax.grad of the reference's naive ``ref_rwkv6`` (no state)."""
    r, k, v, w, u, _, dy, _ = wkv_inputs(b, t, seed=1)
    _, vjp = jax.vjp(jref.ref_rwkv6, *(jnp.asarray(a)
                                       for a in (r, k, v, w, u)))
    want = vjp(jnp.asarray(dy))
    got = ref.ref_rwkv6_bwd(*(torch.tensor(a) for a in (r, k, v, w, u)),
                            None, torch.tensor(dy), None)
    assert_grads(got[:5], [np.asarray(g) for g in want],
                 ("dr", "dk", "dv", "dw", "du"))


@pytest.mark.parametrize("t,chunk", [(17, 16), (64, 16), (100, 25)])
def test_wkv_bwd_matches_jax_wkv_chunked(t, chunk):
    """Against jax.grad of the reference model's ``wkv_chunked`` from an
    initial state, with a cotangent on its final state."""
    b = 2
    r, k, v, w, u, s0, dy, ds_t = wkv_inputs(b, t, seed=2)

    def flat(a):
        return jnp.asarray(a.reshape(b, t, H * HD))

    def f(r_, k_, v_, w_, u_, s0_):
        return jrwkv.wkv_chunked(r_, k_, v_, w_, u_, H, HD, chunk, s0_)
    _, vjp = jax.vjp(f, flat(r), flat(k), flat(v), flat(w),
                     jnp.asarray(u.reshape(-1)), jnp.asarray(s0))
    want = [np.asarray(g) for g in vjp((flat(dy), jnp.asarray(ds_t)))]
    want = [g.reshape(b, t, H, HD) for g in want[:4]] \
        + [want[4].reshape(H, HD), want[5]]
    got = ref.ref_rwkv6_bwd(*(torch.tensor(a) for a in wkv_inputs(
        b, t, seed=2)))
    assert_grads(got, want, ("dr", "dk", "dv", "dw", "du", "ds0"))


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("b,t", CASES)
def test_ssd_bwd_matches_autograd(b, t, sliced):
    """With h0 and a final-state cotangent; x, B and C also as strided
    slices of one projection."""
    x, dt, a_log, bb, cc, d, h0, dy, dh_t = ssd_inputs(b, t, sliced=sliced)
    got = ref.ref_ssd_bwd(x, dt, a_log, bb, cc, d, h0, dy, dh_t)
    want = autograd(lambda *a: ref.ref_ssd(*a[:6], h0=a[6],
                                           return_state=True),
                    (x, dt, a_log, bb, cc, d, h0), (dy, dh_t))
    assert_grads(got, want, ("dx", "ddt", "da_log", "db", "dc", "dd",
                             "dh0"))


@pytest.mark.parametrize("b,t", CASES)
def test_ssd_bwd_matches_jax_oracle(b, t):
    """Against jax.grad of the reference's naive ``ref_ssd`` (no state) at
    the model's decays, A up to 16."""
    x, dt, a_log, bb, cc, d, _, dy, _ = ssd_inputs(b, t, seed=1)
    prim = [jnp.asarray(a.numpy()) for a in (x, dt, a_log, bb, cc, d)]
    _, vjp = jax.vjp(jref.ref_ssd, *prim)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy.numpy()))]
    got = ref.ref_ssd_bwd(x, dt, a_log, bb, cc, d, None, dy, None)
    assert_grads(got[:6], want, ("dx", "ddt", "da_log", "db", "dc", "dd"))


def test_reference_chunked_ssd_gradient_is_nan_where_the_port_is_finite():
    """The reference model's ``ssd_chunked`` at chunk 16 and the model's
    decays (A up to 16, softplus(dt) ~ 0.7: L_t - L_s reaches ~170 above
    the diagonal, past float32's ~88.7) gives NaN gradients; its forward is
    finite.  The port's ``ssd_op`` gives finite gradients there, equal to
    jax.grad of the naive ``ref_ssd``."""
    b, t = 2, 64
    x, dt, a_log, bb, cc, d, _, dy, _ = ssd_inputs(b, t, seed=3)
    prim = [jnp.asarray(a.numpy()) for a in (x, dt, a_log, bb, cc, d)]

    def chunked(x_, dt_, a_, b_, c_, d_):
        return jssm.ssd_chunked(x_, dt_, a_, b_, c_, d_, 16)[0]
    y, vjp = jax.vjp(chunked, *prim)
    assert np.isfinite(np.asarray(y)).all()
    bad = vjp(jnp.asarray(dy.numpy()))
    assert any(np.isnan(np.asarray(g)).any() for g in bad)
    _, vjp_naive = jax.vjp(jref.ref_ssd, *prim)
    want = [np.asarray(g) for g in vjp_naive(jnp.asarray(dy.numpy()))]
    xs = [a.clone().requires_grad_() for a in (x, dt, a_log, bb, cc, d)]
    got = torch.autograd.grad((ssd_op(*xs) * dy).sum(), xs)
    assert_grads(got, want, ("dx", "ddt", "da_log", "db", "dc", "dd"))


def test_ops_are_differentiable_and_the_serve_path_is_forward_only():
    """``rwkv6_op`` / ``ssd_op`` with a gradient wanted: the plain backward
    through autograd, gradients in their inputs' dtypes; without one: the
    forward alone, no graph.  (On the CPU no kernel counts.)"""
    reset_counters()
    r, k, v, w, u, s0, dy, ds_t = (torch.tensor(a)
                                   for a in wkv_inputs(2, 17, seed=4))
    xs = [a.clone().requires_grad_() for a in (r, k, v, w, u, s0)]
    y, s_t = rwkv6_op(*xs[:5], xs[5], return_state=True)
    got = torch.autograd.grad((y * dy).sum() + (s_t * ds_t).sum(), xs)
    want = ref.ref_rwkv6_bwd(r, k, v, w, u, s0, dy, ds_t)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
    # bf16 activations give bf16 gradients; u stays fp32
    xb = [a.to(torch.bfloat16).requires_grad_() for a in (r, k, v)]
    yb = rwkv6_op(*xb, w, u.requires_grad_())
    gb = torch.autograd.grad(yb.sum(), [*xb, u])
    assert [g.dtype for g in gb] == [torch.bfloat16] * 3 + [torch.float32]
    with torch.no_grad():
        y0 = rwkv6_op(*xs[:5], xs[5])
    assert y0.grad_fn is None
    torch.testing.assert_close(y0, y.detach(), rtol=0, atol=0)

    x, dt, a_log, bb, cc, d, h0, dy, dh_t = ssd_inputs(2, 17, seed=4,
                                                       sliced=True)
    xs = [a.clone().requires_grad_() for a in (x, dt, a_log, bb, cc, d, h0)]
    y, h_t = ssd_op(*xs, return_state=True)
    got = torch.autograd.grad((y * dy).sum() + (h_t * dh_t).sum(), xs)
    want = ref.ref_ssd_bwd(x, dt, a_log, bb, cc, d, h0, dy, dh_t)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
    with torch.inference_mode():
        assert ssd_op(x, dt, a_log, bb, cc, d).grad_fn is None
    assert all(c.count == 0 for c in COUNTERS.values())


def test_backward_wrappers_refuse_bad_shapes():
    r, k, v, w, u, s0, dy, ds_t = (torch.tensor(a)
                                   for a in wkv_inputs(1, 5))
    with pytest.raises(ValueError, match="dy"):
        rwkv6_wkv_bwd(r, k, v, w, u, s0, dy[:, :4], ds_t)
    with pytest.raises(ValueError, match="ds_t"):
        rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_t[:, :1])
    x, dt, a_log, bb, cc, d, h0, dy, dh_t = ssd_inputs(1, 5)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, a_log, bb, cc, d, h0, dy[:, :4], dh_t)
    with pytest.raises(ValueError, match="dh_t"):
        ssd_scan_bwd(x, dt, a_log, bb, cc, d, h0, dy, dh_t[..., :2])
