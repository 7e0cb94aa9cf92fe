"""Plain PyTorch versions of the port's ten kernels (the allclose
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
    vals, ids = [], []
    for _ in range(k):
        arg = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(p, -1, arg))
        ids.append(arg)
        p = p.scatter(-1, arg, float("-inf"))   # out of place: autograd
    return torch.cat(vals, -1), torch.cat(ids, -1).to(torch.int32)


def ref_grouped_ffn(x, wi, wu, wo, ffn_type: str = "swiglu",
                    group_expert=None, group_rows=None):
    """Grouped expert FFN.  x: [G, T, D]; wi/wu: [G, D, F]; wo: [G, F, D].
    With ``group_expert`` [G] the weights are [E, ...] and group g uses
    expert group_expert[g] (-1: zeros); with ``group_rows`` [G], rows r >=
    group_rows[g] are zeros."""
    if group_expert is not None:
        safe = torch.clamp(group_expert, min=0).long()
        wi, wo = wi[safe], wo[safe]
        wu = wu[safe] if wu is not None else None
    h = torch.einsum("etd,edf->etf", x, wi)
    if ffn_type == "swiglu":
        h = F.silu(h) * torch.einsum("etd,edf->etf", x, wu)
    else:
        h = gelu(h)
    out = torch.einsum("etf,efd->etd", h, wo).to(x.dtype)
    if group_expert is None and group_rows is None:
        return out
    keep = torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
    if group_rows is not None:
        keep &= torch.arange(out.shape[1], device=out.device)[None, :] \
            < group_rows[:, None]
    if group_expert is not None:
        keep &= (group_expert >= 0)[:, None]
    return torch.where(keep[..., None], out, torch.zeros_like(out))


def ref_grouped_matmul(a, b):
    """Grouped GEMM in fp32.  a: [E, M, K]; b: [E, K, N] -> [E, M, N] f32."""
    return torch.matmul(a.float(), b.float())


def ref_topk_gating(logits, k: int):
    """Router softmax + top-k.  logits: [T, E].
    Returns (expert_idx [T,k] i32, gate_w [T,k] f32 renormalized, probs)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = first_max_topk(probs, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return idx, w, probs


def ref_dispatch_rows(x, src_tok, scale=None, *, dot=None):
    """Slot-buffer dispatch.  x: [T, d]; src_tok: [R] source token per slot
    row (-1 empty); scale: optional [R] f32.  -> [R, d] in x.dtype.  With
    ``dot`` ([R, d]) -> (out, rowdot): rowdot [R] f32 the fp32 dot of each
    slot row of ``dot`` with its unscaled source row, 0 for empty rows."""
    rows = x[torch.clamp(src_tok, min=0).long()]
    one = torch.ones_like(src_tok, dtype=torch.float32) if scale is None \
        else scale.float()
    s = torch.where(src_tok >= 0, one, torch.zeros_like(one))
    out = (rows.float() * s[:, None]).to(x.dtype)
    if dot is None:
        return out
    rowdot = torch.sum(dot.float() * rows.float(), dim=-1)
    return out, torch.where(src_tok >= 0, rowdot, torch.zeros_like(rowdot))


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


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention in fp32.  q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] ->
    [B, Sq, H, hd] in q.dtype.  Query head h reads KV head h // (H/KV);
    masked logits are -1e30, the scale is hd**-0.5; query and key
    positions both start at 0."""
    b, sq, h, hd = q.shape
    rep = h // k.shape[2]
    kk = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vv = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kk.float()) / (hd ** 0.5)
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window:
        mask &= kpos[None] > qpos[:, None] - window
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv.float()).to(q.dtype)


def ref_rwkv6(r, k, v, w, u, s0=None, return_state: bool = False):
    """Naive RWKV6 recurrence.  r/k/v/w: [B, T, H, hd] (w = log decay < 0);
    u: [H, hd]; s0: [B, H, hd, hd] initial state (zeros when None).
    Returns y [B, T, H, hd] (f32), and with ``return_state`` also the final
    state [B, H, hd, hd] (f32).  Per step:
    y_t = r_t @ (S + u k_t v_t^T), S <- exp(w_t)[:, None] S + k_t v_t^T."""
    b, t, h, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    s = torch.zeros((b, h, hd, hd), device=r.device) if s0 is None \
        else s0.float()
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]       # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + uu * kv))
        s = torch.exp(w[:, i])[..., None] * s + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros((b, 0, h, hd))
    return (y, s) if return_state else y


def ref_ssd(x, dt, a_log, b, c, d_skip, h0=None, return_state: bool = False):
    """Naive Mamba2/SSD recurrence.  x: [B,T,H,P]; dt: [B,T,H] (pre-softplus);
    a_log: [H]; b,c: [B,T,N]; d_skip: [H]; h0: [B,H,P,N] initial state
    (zeros when None).  Returns y [B,T,H,P] (f32), and with
    ``return_state`` also the final state [B,H,P,N] (f32)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    dtp = F.softplus(dt.float())
    x, b, c = x.float(), b.float(), c.float()
    s = torch.zeros((bsz, h, p, n), device=x.device) if h0 is None \
        else h0.float()
    ys = []
    for i in range(t):
        dec = torch.exp(dtp[:, i] * a[None])                  # [B,H]
        upd = torch.einsum("bhp,bn->bhpn", x[:, i] * dtp[:, i, :, None],
                           b[:, i])
        s = s * dec[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, c[:, i]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, h, p))
    y = y + x * d_skip.float()[None, None, :, None]
    return (y, s) if return_state else y
