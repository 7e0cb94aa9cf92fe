"""Plain PyTorch versions of the serve path's six kernels (the allclose
targets), with the reference oracles' names and signatures.

Each function is the semantic ground truth: simple tensor code with no
tiling.  The CPU tests hold them against the JAX oracles and the Pallas
kernels in interpret mode; ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  Top-k is an iterated first-max ``argmax`` everywhere
(``torch.topk`` does not promise which of two equal values comes first), and
gelu is the tanh form, as ``jax.nn.gelu`` is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def first_max_topk(p, k: int):
    """Top-k along the last axis by iterated first-max argmax: ties go to
    the lower index, as in ``lax.top_k`` and the Pallas gating kernel.
    Returns (values, int32 indices), each [..., k]."""
    p = p.clone()
    vals, ids = [], []
    for _ in range(k):
        arg = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(p, -1, arg))
        ids.append(arg)
        p.scatter_(-1, arg, float("-inf"))
    return torch.cat(vals, -1), torch.cat(ids, -1).to(torch.int32)


def ref_grouped_ffn(x, wi, wu, wo, ffn_type: str = "swiglu"):
    """Grouped expert FFN.  x: [E, T, D]; wi/wu: [E, D, F]; wo: [E, F, D]."""
    h = torch.einsum("etd,edf->etf", x, wi)
    if ffn_type == "swiglu":
        h = F.silu(h) * torch.einsum("etd,edf->etf", x, wu)
    else:
        h = gelu(h)
    return torch.einsum("etf,efd->etd", h, wo).to(x.dtype)


def ref_topk_gating(logits, k: int):
    """Router softmax + top-k.  logits: [T, E].
    Returns (expert_idx [T,k] i32, gate_w [T,k] f32 renormalized, probs)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = first_max_topk(probs, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return idx, w, probs


def ref_dispatch_rows(x, src_tok, scale=None):
    """Slot-buffer dispatch.  x: [T, d]; src_tok: [R] source token per slot
    row (-1 empty); scale: optional [R] f32.  -> [R, d] in x.dtype."""
    rows = x[torch.clamp(src_tok, min=0).long()]
    one = torch.ones_like(src_tok, dtype=torch.float32) if scale is None \
        else scale.float()
    s = torch.where(src_tok >= 0, one, torch.zeros_like(one))
    return (rows.float() * s[:, None]).to(x.dtype)


def ref_combine_rows(buf, rows, weights):
    """Gate-weighted combine.  buf: [R, d]; rows: [T, k] flat slot per
    (token, choice), -1 dropped; weights: [T, k].  -> [T, d] in buf.dtype."""
    vals = buf[torch.clamp(rows, min=0).long()]             # [T, k, d]
    w = torch.where(rows >= 0, weights.float(), torch.zeros_like(
        weights, dtype=torch.float32))
    return torch.sum(vals.float() * w[..., None], dim=1).to(buf.dtype)


def ref_topk_positions(expert_idx, n_experts: int):
    """GShard priority positions.  expert_idx: [T, k] int32 (-1 = masked)
    -> [T, k] int32 choice-major rank of each (token, choice) within its
    expert: all first choices outrank any second choice.  Masked rows get
    rank 0 and do not advance any counter."""
    t, k = expert_idx.shape
    ar = torch.arange(n_experts, dtype=expert_idx.dtype,
                      device=expert_idx.device)
    onehot = (expert_idx[..., None] == ar).to(torch.int32)
    flat = onehot.transpose(0, 1).reshape(k * t, n_experts)
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = pos.reshape(k, t, n_experts).transpose(0, 1)
    return torch.sum(pos * onehot, dim=-1, dtype=torch.int32)


def ref_weighted_route(expert_idx, position, cum_weights, slot_of,
                       slot_cap: int):
    """Weighted replica-bin routing.  expert_idx/position: [T, k] int32;
    cum_weights/slot_of: [E, R] int32 (inclusive weight cumsum / global slot
    per replica, -1 pads) -> [T, k] int32 flat row (slot * slot_cap +
    offset), -1 dropped.  Pure integer arithmetic."""
    idx = torch.clamp(expert_idx, min=0).long()
    cum = cum_weights[idx]                                   # [T, k, R]
    rw = cum.shape[-1]
    total = cum[..., -1]
    ge = position[..., None] >= cum
    which = torch.clamp(ge.to(torch.int32).sum(-1), max=rw - 1)
    prev = torch.where(ge, cum, torch.zeros_like(cum)).amax(-1)
    slot = torch.gather(slot_of[idx], -1, which[..., None].long())[..., 0]
    rows = slot * slot_cap + (position - prev)
    keep = (expert_idx >= 0) & (position < total) & (slot >= 0)
    return torch.where(keep, rows, torch.full_like(rows, -1)).to(torch.int32)
