"""Kernel entry points the port's models call, the backend switch, and the
backward of every MoE op.

``MoEConfig.compute_backend`` maps onto the port as follows:

  ============  ==========================================================
  ``"auto"``    the kernel route: each op calls its kernel wrapper, which
  ``"pallas"``  launches the Hopper kernel for a CUDA tensor and runs its
                plain PyTorch version for a CPU tensor
  ``"xla"``     the plain tensor path (einsum / scatter code in ``core``)
  ============  ==========================================================

So "auto" and "pallas" name the same route here: the device of the tensor
decides, never whether a card is present, and a tensor on any other device
raises (``kernels._build.on_cpu``).  On a CUDA tensor the kernels take
bf16 activations and weights, the compute type of every paper model; a
float32 CUDA tensor raises (``grouped_matmul`` also takes fp32 operands).

The differentiable ops are ``torch.autograd.Function``s whose backward
follows the reference's custom VJPs (``src/repro/kernels/ops.py``) and
launches the same kernels:

  * ``grouped_ffn_op``  — the FFN kernel forward; the backward recomputes
    h (and u) on the full buffers and forms every dgrad / wgrad with
    ``grouped_matmul`` (5 launches for gelu, 8 for swiglu), as two
    halves split by data dependence: ``ffn_dgrad`` (row-local: dx and
    the per-row act, dh, du) and ``ffn_wgrad`` (each weight's gradient,
    one product over every row), which the expert-parallel section
    (``core.moe``) runs chunk by chunk and once.  With
    ``group_expert`` (the serve path's in-place hosted weights) it has no
    backward and raises where a gradient is wanted;
  * ``topk_gating_op``  — the gating kernel forward; the backward
    differentiates the plain ``x @ router`` + softmax + top-k (idx gets no
    gradient);
  * ``dispatch_op``     — the backward is the combine kernel with unit
    weights;
  * ``combine_op``      — the backward is the dispatch kernel with the gate
    weight as the per-row scale; its ``dot=`` operand (the saved slot
    buffer) gives the weights' row-wise dot in the same pass.

  * ``rwkv6_op``        — the RWKV6 WKV recurrence: the WKV kernel
    forward, its own backward kernel (``rwkv6.rwkv6_wkv_bwd``) for the
    gradients of r, k, v, w, u and s0;
  * ``ssd_op``          — the Mamba2 SSD scan: the SSD kernel forward,
    its own backward kernel (``ssd.ssd_scan_bwd``) for the gradients of
    x, dt, a_log, B, C, D and h0.
The reference's Pallas kernels of the two recurrences have no VJP (it
trains them through ``jax.grad`` of its jnp forms); the math of these
backwards is the VJP of the plain recurrences.  Where no gradient is
wanted (``no_grad`` / ``inference_mode``, or no input requiring one) the
two ops launch the forward kernel alone, as the serve path always has.

On a CPU tensor the same Functions run and their kernels' plain versions
run inside (``ref_rwkv6_bwd`` and ``ref_ssd_bwd`` for the recurrences),
so the CPU tests exercise these backward formulas.  Gradients come back
in their inputs' dtypes.  ``topk_positions_op`` and ``weighted_route_op``
have integer outputs and no backward.  ``flash_attention_op`` (the
prefill attention) has no backward, as the reference's Pallas kernel has
no VJP: on a CUDA tensor that requires grad it raises.  The ops make their
inputs contiguous and of the index type the kernels take, except that
``ssd_op`` hands the model's strided slices to the kernels as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                          invert_slots, weighted_route)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_ffn import grouped_ffn, grouped_matmul
from repro_torch.kernels.rwkv6 import rwkv6_wkv, rwkv6_wkv_bwd
from repro_torch.kernels.ssd import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.topk_gating import topk_gating_fused, topk_positions


def resolve_backend(name: str | None) -> str:
    """``MoEConfig.compute_backend`` -> "pallas" (kernel route) or "xla"
    (plain tensor path)."""
    if name in (None, "", "auto", "pallas"):
        return "pallas"
    if name != "xla":
        raise ValueError(f"unknown compute backend {name!r}")
    return name


def kernel_route(cfg) -> bool:
    """Whether a model config's ``moe.compute_backend`` selects the kernel
    route (the RWKV6 / hybrid families read it too)."""
    return resolve_backend(cfg.moe.compute_backend) == "pallas"


def vjp(fn, primals, cotangent):
    """Gradients of ``fn(*primals)`` against ``cotangent`` (plain autograd
    on detached copies, as ``jax.vjp`` of the formula)."""
    with torch.enable_grad():
        xs = [p.detach().requires_grad_() for p in primals]
        out = fn(*xs)
        return torch.autograd.grad(out, xs, cotangent)


# ---------------------------------------------------------------------------
# grouped expert FFN (reference ops.py:_grouped_ffn_fwd / _grouped_ffn_bwd)
# ---------------------------------------------------------------------------

class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wi, wu, wo, group_rows, ffn_type):
        ctx.ffn_type = ffn_type
        ctx.save_for_backward(x, wi, wu, wo)
        return grouped_ffn(x, wi, wu, wo, ffn_type=ffn_type,
                           group_rows=group_rows)

    @staticmethod
    def backward(ctx, dy):
        x, wi, wu, wo = ctx.saved_tensors
        dy = dy.float()
        h = grouped_matmul(x, wi)                     # recompute [E, T, F]
        u = grouped_matmul(x, wu) if wu is not None else None
        dx, act, dh, du = ffn_dgrad(h, u, wi, wu, wo, ctx.ffn_type, dy,
                                    grouped_matmul)
        dwi, dwu, dwo = ffn_wgrad(x, act, dh, du, dy, grouped_matmul)
        return (dx.to(x.dtype), dwi.to(wi.dtype),
                dwu.to(wu.dtype) if dwu is not None else None,
                dwo.to(wo.dtype), None, None)


def ffn_dgrad(h, u, wi, wu, wo, ffn_type: str, dy, mm):
    """The row-local half of the grouped FFN's backward: for rows of the
    recomputed h (and u, swiglu) [E, T, F] and their cotangent dy
    [E, T, D], (dx, act, dh, du or None).  Every row of each result
    depends on that row alone, so the rows may come in chunks; act, dh
    and du are what ``ffn_wgrad`` reads.  ``mm`` forms each product:
    ``grouped_matmul`` (fp32, the reference VJP's; dy then fp32 too) or
    the plain route's ``torch.matmul`` in the operands' dtype."""
    da = mm(dy, wo.transpose(1, 2))                   # [E, T, F]
    if ffn_type == "swiglu":
        act = torch.nn.functional.silu(h) * u
        dh, du = vjp(lambda a, b: torch.nn.functional.silu(a) * b,
                     (h, u), da)
        dx = mm(dh, wi.transpose(1, 2)) + mm(du, wu.transpose(1, 2))
    else:
        act = ref.gelu(h)
        (dh,) = vjp(ref.gelu, (h,), da)
        dx, du = mm(dh, wi.transpose(1, 2)), None
    return dx, act, dh, du


def ffn_wgrad(x, act, dh, du, dy, mm):
    """The weight half of the grouped FFN's backward: (dwi, dwu or None,
    dwo), each one product over every row of x, act, dh (du) and dy
    [E, T, .] (``ffn_dgrad``'s outputs side by side), in ``mm``'s
    dtype; the caller rounds each once to its weight's."""
    xt = x.transpose(1, 2)                            # [E, D, T]
    dwo = mm(act.transpose(1, 2), dy)                 # [E, F, D]
    dwu = mm(xt, du) if du is not None else None
    return mm(xt, dh), dwu, dwo


def grouped_ffn_op(x, wi, wu, wo, ffn_type: str = "swiglu", *,
                   group_expert=None, group_rows=None):
    """The grouped FFN (``moe_ffn.grouped_ffn``), differentiable in x and
    the weights.  ``group_rows`` [G]: rows past each group's count are
    zeros, which the callers' buffers already are there, so the backward
    (on the full buffers) is unchanged.  ``group_expert`` [G]: the weights
    read in place through the group -> expert index; forward only."""
    wu = wu.contiguous() if wu is not None else None
    rows = None if group_rows is None else group_rows.int().contiguous()
    if group_expert is not None:
        if torch.is_grad_enabled() and any(
                a is not None and a.requires_grad for a in (x, wi, wu, wo)):
            raise NotImplementedError(
                "grouped_ffn_op: group_expert has no backward (the serve "
                "path runs without gradients)")
        return grouped_ffn(x.contiguous(), wi.contiguous(), wu,
                           wo.contiguous(), ffn_type=ffn_type,
                           group_expert=group_expert.int().contiguous(),
                           group_rows=rows)
    return _GroupedFFN.apply(x.contiguous(), wi.contiguous(), wu,
                             wo.contiguous(), rows, ffn_type)


# ---------------------------------------------------------------------------
# fused router gating (reference ops.py:_gating_fwd / _gating_bwd)
# ---------------------------------------------------------------------------

class _TopkGating(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, router, k):
        ctx.k = k
        ctx.save_for_backward(x, router)
        idx, w, probs = topk_gating_fused(x, k, router=router)
        ctx.mark_non_differentiable(idx)
        return idx, w, probs

    @staticmethod
    def backward(ctx, didx, dw, dprobs):
        # w / probs backprop through the plain formulation, as the
        # reference's oracle VJP: the same math as the plain route
        x, router = ctx.saved_tensors
        dx, drouter = vjp(
            lambda x_, r_: ref.ref_topk_gating(x_ @ r_, ctx.k)[1:],
            (x, router), (dw, dprobs))
        return dx, drouter, None


def topk_gating_op(x, router, k: int):
    """Fused gating network: x [T, D] @ router [D, E] folded into the
    softmax + top-k kernel -> (idx [T,k] i32, w [T,k] f32, probs [T,E] f32).
    """
    return _TopkGating.apply(x.contiguous(), router.contiguous(), k)


def topk_positions_op(expert_idx, n_experts: int):
    """expert_idx [T, k] i32 -> [T, k] i32 choice-major priority rank."""
    return topk_positions(expert_idx.int().contiguous(), n_experts)


def weighted_route_op(expert_idx, position, cum_weights, slot_of,
                      slot_cap: int):
    """(expert, priority position) -> flat replica row, -1 dropped."""
    return weighted_route(expert_idx.int().contiguous(),
                          position.int().contiguous(),
                          cum_weights.int().contiguous(),
                          slot_of.int().contiguous(), slot_cap)


# ---------------------------------------------------------------------------
# dispatch / combine (reference ops.py:_dispatch_bwd / _combine_bwd)
# ---------------------------------------------------------------------------

class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src_tok, tok_rows):
        ctx.save_for_backward(tok_rows)
        return dispatch_rows(x, src_tok)

    @staticmethod
    def backward(ctx, dbuf):
        # dispatch is a masked permutation of token rows: the cotangent of
        # token t is the sum of its slot rows, an unweighted combine
        (tok_rows,) = ctx.saved_tensors
        ones = torch.ones(tok_rows.shape, dtype=torch.float32,
                          device=tok_rows.device)
        return combine_rows(dbuf.contiguous(), tok_rows, ones), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, rows, weights):
        ctx.save_for_backward(buf, rows, weights)
        return combine_rows(buf, rows, weights)

    @staticmethod
    def backward(ctx, dy):
        buf, rows, weights = ctx.saved_tensors
        t, k = rows.shape
        # d buf: each (token, choice)'s slot row gets w[t,k] * dy[t] — the
        # dispatch kernel with the gate weight as the per-row scale; d
        # weights: dot(buf[rows[t,k]], dy[t]), which the same pass returns
        # per slot row as rowdot (rows and src_tok are inverse maps)
        src_tok, src_k = invert_slots(rows, buf.shape[0])
        w_flat = weights.reshape(-1).float()
        pick = torch.clamp(src_tok * k + src_k, min=0).long()
        scale = torch.where(src_tok >= 0, w_flat[pick],
                            torch.zeros_like(w_flat[pick]))
        dbuf, rowdot = dispatch_rows(dy.to(buf.dtype).contiguous(), src_tok,
                                     scale.contiguous(), dot=buf)
        dw = torch.where(rows >= 0, rowdot[torch.clamp(rows, min=0).long()],
                         torch.zeros((), device=rowdot.device))
        return dbuf, None, dw.to(weights.dtype)


def dispatch_op(x, src_tok, tok_rows):
    """x [T, d], src_tok [R] i32, tok_rows [T, k] (flat row per (token,
    choice), -1 dropped) -> [R, d] slot rows (0 where src = -1);
    differentiable in x."""
    return _Dispatch.apply(x.contiguous(), src_tok.int().contiguous(),
                           tok_rows.int().contiguous())


def combine_op(buf, rows, weights):
    """buf [R, d], rows [T, k] i32, weights [T, k] -> [T, d] in buf.dtype;
    differentiable in buf and weights."""
    return _Combine.apply(buf.contiguous(), rows.int().contiguous(),
                          weights.float().contiguous())


# ---------------------------------------------------------------------------
# prefill attention (reference ops.py:flash_attention_op; forward only)
# ---------------------------------------------------------------------------

def flash_attention_op(q, k, v, causal: bool = True, window: int = 0):
    """q [B, S, H, hd], k/v [B, S, KV, hd] -> [B, S, H, hd] in q.dtype:
    the flash kernel for CUDA tensors, its plain version for CPU ones."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


# ---------------------------------------------------------------------------
# the recurrences of the RWKV6 and Mamba2 families (reference ops.py:
# rwkv6_op / ssd_op; the backward its jax.grad of the jnp forms)
# ---------------------------------------------------------------------------

def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in tensors)


def _cast(grad, like):
    """A gradient in its input's dtype (None where there is no input)."""
    return None if like is None else grad.to(like.dtype)


class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_t)
        return tuple(_cast(g, a) for g, a in zip(grads, (r, k, v, w, u, s0)))


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, h0)
        return ssd_scan(x, dt, a_log, b, c, d_skip, h0=h0, return_state=True)

    @staticmethod
    def backward(ctx, dy, dh_t):
        x, dt, a_log, b, c, d_skip, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
        return tuple(_cast(g, a) for g, a in
                     zip(grads, (x, dt, a_log, b, c, d_skip, h0)))


def rwkv6_op(r, k, v, w, u, s0=None, *, return_state: bool = False):
    """r/k/v/w [B, T, H, hd] (w the log decay), u [H, hd], s0 [B, H, hd,
    hd] or None -> y [B, T, H, hd] float32 (, final state): the WKV kernel
    for CUDA tensors, its plain version for CPU ones; differentiable in
    every input (the backward kernel where a gradient is wanted)."""
    r, k, v, w = (a.contiguous() for a in (r, k, v, w))
    s0 = None if s0 is None else s0.contiguous()
    if not _wants_grad(r, k, v, w, u, s0):
        return rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=return_state)
    y, s_t = _RWKV6.apply(r, k, v, w, u, s0)
    return (y, s_t) if return_state else y


def ssd_op(x, dt, a_log, b, c, d_skip, h0=None, *,
           return_state: bool = False):
    """x [B, T, H, P], dt [B, T, H], a_log / d_skip [H], b / c [B, T, N],
    h0 [B, H, P, N] or None -> y [B, T, H, P] float32 (, final state): the
    SSD kernel for CUDA tensors, its plain version for CPU ones;
    differentiable in every input (the backward kernel where a gradient is
    wanted)."""
    h0 = None if h0 is None else h0.contiguous()
    if not _wants_grad(x, dt, a_log, b, c, d_skip, h0):
        return ssd_scan(x, dt, a_log, b, c, d_skip, h0=h0,
                        return_state=return_state)
    y, h_t = _SSD.apply(x, dt, a_log, b, c, d_skip, h0)
    return (y, h_t) if return_state else y
