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
    ``grouped_matmul`` (5 launches for gelu, 8 for swiglu).  With
    ``group_expert`` (the serve path's in-place hosted weights) it has no
    backward and raises where a gradient is wanted;
  * ``topk_gating_op``  — the gating kernel forward; the backward
    differentiates the plain ``x @ router`` + softmax + top-k (idx gets no
    gradient);
  * ``dispatch_op``     — the backward is the combine kernel with unit
    weights;
  * ``combine_op``      — the backward is the dispatch kernel with the gate
    weight as the per-row scale, plus a row-wise dot for the weights.

On a CPU tensor the same Functions run and their kernels' plain versions
run inside, so the CPU tests exercise these backward formulas.
``topk_positions_op`` and ``weighted_route_op`` have integer outputs and no
backward.  ``flash_attention_op`` (the prefill attention), ``rwkv6_op`` (the
RWKV6 WKV recurrence) and ``ssd_op`` (the Mamba2 SSD scan) have no backward
either, as the reference's Pallas kernels have no VJP: on a CUDA tensor
that requires grad they raise.  The ops make their inputs contiguous and
of the index type the kernels take, except that ``ssd_op`` hands the
model's strided slices to the kernel as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                          invert_slots, weighted_route)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_ffn import grouped_ffn, grouped_matmul
from repro_torch.kernels.rwkv6 import rwkv6_wkv
from repro_torch.kernels.ssd import ssd_scan
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


def _vjp(fn, primals, cotangent):
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
        xt = x.transpose(1, 2)                            # [E, D, T]
        h = grouped_matmul(x, wi)                         # recompute [E, T, F]
        if ctx.ffn_type == "swiglu":
            u = grouped_matmul(x, wu)
            act = torch.nn.functional.silu(h) * u
        else:
            act = ref.gelu(h)
        da = grouped_matmul(dy, wo.transpose(1, 2))       # [E, T, F]
        dwo = grouped_matmul(act.transpose(1, 2), dy)     # [E, F, D]
        if ctx.ffn_type == "swiglu":
            dh, du = _vjp(lambda a, b: torch.nn.functional.silu(a) * b,
                          (h, u), da)
            dx = grouped_matmul(dh, wi.transpose(1, 2)) \
                + grouped_matmul(du, wu.transpose(1, 2))
            dwu = grouped_matmul(xt, du).to(wu.dtype)
        else:
            (dh,) = _vjp(ref.gelu, (h,), da)
            dx = grouped_matmul(dh, wi.transpose(1, 2))
            dwu = None
        dwi = grouped_matmul(xt, dh)
        return (dx.to(x.dtype), dwi.to(wi.dtype), dwu, dwo.to(wo.dtype),
                None, None)


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
        dx, drouter = _vjp(
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
        # dispatch kernel with the gate weight as the per-row scale
        src_tok, src_k = invert_slots(rows, buf.shape[0])
        w_flat = weights.reshape(-1).float()
        pick = torch.clamp(src_tok * k + src_k, min=0).long()
        scale = torch.where(src_tok >= 0, w_flat[pick],
                            torch.zeros_like(w_flat[pick]))
        dbuf = dispatch_rows(dy.to(buf.dtype).contiguous(), src_tok,
                             scale.contiguous())
        # d weights: row-wise dot of dy with the gathered slot rows
        vals = buf[torch.clamp(rows, min=0).long()].float()     # [T, k, d]
        dw = torch.sum(vals * dy.float()[:, None, :], dim=-1)
        dw = torch.where(rows >= 0, dw, torch.zeros_like(dw))
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
# rwkv6_op / ssd_op; forward only)
# ---------------------------------------------------------------------------

def rwkv6_op(r, k, v, w, u, s0=None, *, return_state: bool = False):
    """r/k/v/w [B, T, H, hd] (w the log decay), u [H, hd], s0 [B, H, hd,
    hd] or None -> y [B, T, H, hd] float32 (, final state): the WKV kernel
    for CUDA tensors, its plain version for CPU ones."""
    return rwkv6_wkv(r.contiguous(), k.contiguous(), v.contiguous(),
                     w.contiguous(), u, s0=None if s0 is None
                     else s0.contiguous(), return_state=return_state)


def ssd_op(x, dt, a_log, b, c, d_skip, h0=None, *,
           return_state: bool = False):
    """x [B, T, H, P], dt [B, T, H], a_log / d_skip [H], b / c [B, T, N],
    h0 [B, H, P, N] or None -> y [B, T, H, P] float32 (, final state): the
    SSD kernel for CUDA tensors, its plain version for CPU ones."""
    return ssd_scan(x, dt, a_log, b, c, d_skip,
                    h0=None if h0 is None else h0.contiguous(),
                    return_state=return_state)
