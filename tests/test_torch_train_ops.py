"""The port's differentiable MoE ops on the CPU against the JAX reference.

* ``grouped_matmul``'s plain version against the reference's Pallas kernel
  (interpret mode), on ragged M / N / K with every bf16 / fp32 operand mix,
  also through the wrapper with transposed operands;
* the gradients of each ``torch.autograd.Function`` in
  ``repro_torch.kernels.ops`` (run on the CPU, so their backward formulas
  call the kernels' plain versions) against ``jax.grad`` of the reference
  op with ``use_pallas=True`` (its custom VJP, interpret mode) and
  ``use_pallas=False`` (autodiff of its oracle); each backward also calls
  the kernels the reference's VJP calls, as many times;
* ``moe_layer`` gradients against the reference ``moe_layer(None, ...)``
  on both routes, and the ``einsum`` dispatch backend against its
  reference.

Tolerances at float32: atol = rtol = 1e-4 (XLA and PyTorch sum in other
orders; bf16 operands are exact in fp32), integer outputs exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import dispatch as jD
from repro.core import gating as jG
from repro.core.moe import MoEParams as JMoEParams
from repro.core.moe import moe_layer as j_moe_layer
from repro.kernels import ops as jops
from repro.kernels.dispatch import invert_slots as j_invert
from repro.kernels.moe_ffn import grouped_matmul as j_grouped_matmul
from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as D
from repro_torch.core import gating as G
from repro_torch.core.moe import MoEParams, moe_layer
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dispatch import invert_slots
from repro_torch.kernels.moe_ffn import grouped_matmul

TOL = dict(atol=1e-4, rtol=1e-4)


def t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


class CallCount:
    """Wrap ``module.name`` to count its calls (restored by monkeypatch)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        real = getattr(module, name)

        def counted(*a, **kw):
            self.n += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, counted)


# ---------------------------------------------------------------------------
# grouped_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_bf16,b_bf16", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("e,m,n,k", [(2, 13, 37, 29), (3, 1, 5, 130)])
def test_grouped_matmul_matches_reference_kernel(e, m, n, k, a_bf16, b_bf16):
    rng = np.random.RandomState(m + n + k)
    a = rng.randn(e, m, k).astype(np.float32)
    b = rng.randn(e, k, n).astype(np.float32)
    ja = jnp.asarray(a, jnp.bfloat16 if a_bf16 else jnp.float32)
    jb = jnp.asarray(b, jnp.bfloat16 if b_bf16 else jnp.float32)
    want = j_grouped_matmul(ja, jb, block_m=8, block_n=128, block_k=128,
                            interpret=True)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32)))
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32)))
    ta = ta.bfloat16() if a_bf16 else ta
    tb = tb.bfloat16() if b_bf16 else tb
    got = ref.ref_grouped_matmul(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (e, m, n)
    close(got, want)
    # the wrapper with operands stored transposed (read in place on the card)
    at = ta.transpose(1, 2).contiguous().transpose(1, 2)
    bt = tb.transpose(1, 2).contiguous().transpose(1, 2)
    close(grouped_matmul(at, bt), want)


def test_grouped_matmul_zero_depth_gives_zeros():
    out = grouped_matmul(torch.zeros(2, 3, 0), torch.zeros(2, 0, 4))
    assert out.shape == (2, 3, 4) and not out.any()


# ---------------------------------------------------------------------------
# grouped FFN: forward kernel + grouped-GEMM backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ffn_type,n_mm", [("gelu", 5), ("swiglu", 8)])
def test_grouped_ffn_backward_matches_reference(monkeypatch, ffn_type, n_mm):
    rng = np.random.RandomState(3)
    e, tt, d, f = 3, 12, 32, 64
    x = rng.randn(e, tt, d).astype(np.float32)
    wi = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    wu = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32) \
        if ffn_type == "swiglu" else None
    wo = (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32)
    ct = rng.randn(e, tt, d).astype(np.float32)

    def jloss(use_pallas):
        def fn(x_, wi_, wu_, wo_):
            y = jops.grouped_ffn_op(x_, wi_, wu_, wo_, ffn_type,
                                    use_pallas=use_pallas)
            return jnp.sum(y * ct)
        argn = (0, 1, 2, 3) if wu is not None else (0, 1, 3)
        return jax.grad(fn, argnums=argn)(
            jnp.asarray(x), jnp.asarray(wi),
            None if wu is None else jnp.asarray(wu), jnp.asarray(wo))

    mm = CallCount(monkeypatch, ops, "grouped_matmul")
    xs = [t(x, True), t(wi, True), t(wu, True) if wu is not None else None,
          t(wo, True)]
    y = ops.grouped_ffn_op(*xs, ffn_type)
    close(y, ref.ref_grouped_ffn(*[None if a is None else a.detach()
                                   for a in xs], ffn_type))
    leaves = [a for a in xs if a is not None]
    grads = torch.autograd.grad((y * t(ct)).sum(), leaves)
    assert mm.n == n_mm
    for use_pallas in (True, False):
        for g, w in zip(grads, jloss(use_pallas)):
            close(g, w)


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_gating_backward_matches_reference(k):
    rng = np.random.RandomState(10 + k)
    tt, d, e = 19, 16, 6
    x = rng.randn(tt, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    cw = rng.randn(tt, k).astype(np.float32)
    cp = rng.randn(tt, e).astype(np.float32)

    def jgrads(use_pallas):
        def fn(x_, r_):
            idx, w, probs = jops.topk_gating_op(x_, r_, k,
                                                use_pallas=use_pallas)
            return jnp.sum(w * cw) + jnp.sum(probs * cp), idx
        return jax.grad(fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(router))

    tx, tr = t(x, True), t(router, True)
    idx, w, probs = ops.topk_gating_op(tx, tr, k)
    assert not idx.requires_grad
    gx, gr = torch.autograd.grad((w * t(cw)).sum() + (probs * t(cp)).sum(),
                                 (tx, tr))
    for use_pallas in (True, False):
        (jx, jr), jidx = jgrads(use_pallas)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        close(gx, jx)
        close(gr, jr)


# ---------------------------------------------------------------------------
# dispatch / combine, with dropped tokens
# ---------------------------------------------------------------------------

def _rows(rng, tt, k, n_rows, n_drop):
    """[T, k] distinct destination rows with ``n_drop`` choices dropped."""
    rows = rng.permutation(n_rows)[:tt * k].reshape(tt, k).astype(np.int32)
    flat = rows.reshape(-1)
    flat[rng.choice(tt * k, n_drop, replace=False)] = -1
    return rows


def test_dispatch_and_combine_backward_match_reference(monkeypatch):
    rng = np.random.RandomState(5)
    tt, k, d, n_rows = 14, 2, 24, 40
    rows = _rows(rng, tt, k, n_rows, n_drop=5)
    x = rng.randn(tt, d).astype(np.float32)
    buf = rng.randn(n_rows, d).astype(np.float32)
    w = rng.rand(tt, k).astype(np.float32)
    cb = rng.randn(n_rows, d).astype(np.float32)
    cy = rng.randn(tt, d).astype(np.float32)
    jsrc, _ = j_invert(jnp.asarray(rows), n_rows)
    src, _ = invert_slots(torch.from_numpy(rows), n_rows)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))

    comb_calls = CallCount(monkeypatch, ops, "combine_rows")
    disp_calls = CallCount(monkeypatch, ops, "dispatch_rows")
    tx = t(x, True)
    out = ops.dispatch_op(tx, src, torch.from_numpy(rows))
    (gx,) = torch.autograd.grad((out * t(cb)).sum(), (tx,))
    assert (disp_calls.n, comb_calls.n) == (1, 1)      # forward + backward
    tb, tw = t(buf, True), t(w, True)
    y = ops.combine_op(tb, torch.from_numpy(rows), tw)
    gb, gw = torch.autograd.grad((y * t(cy)).sum(), (tb, tw))
    assert (disp_calls.n, comb_calls.n) == (2, 2)

    for use_pallas in (True, False):
        disp, comb = jops.dispatch_combine_op(use_pallas=use_pallas)
        jx = jax.grad(lambda x_: jnp.sum(
            disp(x_, jsrc, jnp.asarray(rows)) * cb))(jnp.asarray(x))
        jb, jw = jax.grad(lambda b_, w_: jnp.sum(
            comb(b_, jnp.asarray(rows), w_) * cy), argnums=(0, 1))(
            jnp.asarray(buf), jnp.asarray(w))
        close(out, disp(jnp.asarray(x), jsrc, jnp.asarray(rows)))
        close(gx, jx)
        close(gb, jb)
        close(gw, jw)


# ---------------------------------------------------------------------------
# the MoE layer and the einsum dispatch backend
# ---------------------------------------------------------------------------

def _moe_inputs(seed, ffn_type):
    rng = np.random.RandomState(seed)
    b, s, d, e, f = 2, 12, 32, 4, 64
    x = rng.randn(b, s, d).astype(np.float32)
    p = [(rng.randn(d, e) / np.sqrt(d)).astype(np.float32),
         (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
         (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
         if ffn_type == "swiglu" else None,
         (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32)]
    ct = rng.randn(b, s, d).astype(np.float32)
    return x, p, ct


@pytest.mark.parametrize("backend,dispatch_backend,ffn_type", [
    ("xla", "scatter", "gelu"), ("xla", "einsum", "swiglu"),
    ("pallas", "pallas", "gelu"), ("pallas", "pallas", "swiglu")])
def test_moe_layer_grads_match_reference(backend, dispatch_backend,
                                         ffn_type):
    x, p, ct = _moe_inputs(7, ffn_type)
    # capacity factor 0.75 drops tokens, so the dropped path is exercised
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.75,
              compute_backend=backend)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    has_wu = p[2] is not None

    def jfn(x_, router, wi, wu, wo):
        out = j_moe_layer(None, x_, JMoEParams(router, wi, wu, wo), jcfg,
                          ffn_type=ffn_type,
                          dispatch_backend=dispatch_backend, lina=False)
        return jnp.sum(out.y * ct) + out.aux_loss, out

    argn = (0, 1, 2, 3, 4) if has_wu else (0, 1, 2, 4)
    jgrads, jout = jax.jit(jax.grad(jfn, argnums=argn, has_aux=True))(
        jnp.asarray(x), *[None if a is None else jnp.asarray(a) for a in p])

    tx = t(x, True)
    tp = [None if a is None else t(a, True) for a in p]
    out = moe_layer(tx, MoEParams(*tp), cfg, ffn_type=ffn_type,
                    dispatch_backend=dispatch_backend)
    np.testing.assert_array_equal(out.expert_idx.numpy(),
                                  np.asarray(jout.expert_idx))
    close(out.y, jout.y)
    close(out.aux_loss, jout.aux_loss)
    leaves = [tx] + [a for a in tp if a is not None]
    grads = torch.autograd.grad((out.y * t(ct)).sum() + out.aux_loss, leaves)
    for g, w in zip(grads, jgrads):
        close(g, w)


def test_einsum_dispatch_backend_matches_reference():
    rng = np.random.RandomState(2)
    tt, d, e, k = 20, 16, 4, 2
    cap = 8
    logits = rng.randn(tt, e).astype(np.float32)
    x = rng.randn(tt, d).astype(np.float32)
    buf = rng.randn(e, cap, d).astype(np.float32)
    jg = jG.top_k_gating(jnp.asarray(logits), k, cap)
    g = G.top_k_gating(torch.from_numpy(logits), k, cap)
    assert bool(g.dropped.any())
    np.testing.assert_array_equal(
        D.dispatch_mask(g, e, cap).numpy(),
        np.asarray(jD.dispatch_mask(jg, e, cap)))
    for name in ("einsum", "scatter", "pallas"):
        disp, comb = D.get_backend(name)
        close(disp(torch.from_numpy(x), g, e, cap),
              jD.dispatch_einsum(jnp.asarray(x), jg, e, cap))
        close(comb(torch.from_numpy(buf), g, e, cap),
              jD.combine_einsum(jnp.asarray(buf), jg, e, cap))
