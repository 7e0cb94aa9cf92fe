"""Plain PyTorch versions of the port's twelve kernels (the allclose
targets): the ten TPU kernels', with the reference oracles' names and
signatures, and the two recurrences' backward (``ref_rwkv6_bwd``,
``ref_ssd_bwd``), which the reference leaves to ``jax.grad``.

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


def ref_rwkv6_bwd(r, k, v, w, u, s0, dy, ds_t):
    """The VJP of ``ref_rwkv6`` as an explicit reverse-time recurrence in
    fp32 (no autograd).  r/k/v/w: [B, T, H, hd]; u: [H, hd]; s0: [B, H,
    hd, hd] or None (zeros); dy: [B, T, H, hd] the cotangent of y; ds_t:
    [B, H, hd, hd] or None the cotangent of the final state.  Returns
    (dr, dk, dv, dw, du [H, hd], ds0), all float32.  With S_{t-1} the
    state before step t and G_t the cotangent of the state after it:
        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = u r_t (v_t . dy_t) + G_t v_t
        dv_t = (r_t . u k_t) dy_t + G_t^T k_t
        dw_t = e^{w_t} rowsum(S_{t-1} * G_t)
        du   = sum_{b, t} r_t k_t (v_t . dy_t)
        G_{t-1} = e^{w_t}[:, None] G_t + r_t dy_t^T,   ds0 = G_{-1}.
    The states are kept from a forward sweep, never recovered by
    dividing by the decay."""
    b, t, h, hd = r.shape
    r, k, v, w, dy = (a.float() for a in (r, k, v, w, dy))
    uu = u.float()
    s = torch.zeros((b, h, hd, hd), device=r.device) if s0 is None \
        else s0.float()
    before = []
    for i in range(t):
        before.append(s)
        s = torch.exp(w[:, i])[..., None] * s \
            + k[:, i, :, :, None] * v[:, i, :, None, :]
    g = torch.zeros((b, h, hd, hd), device=r.device) if ds_t is None \
        else ds_t.float()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((h, hd), device=r.device)
    for i in reversed(range(t)):
        ri, ki, vi, dyi = r[:, i], k[:, i], v[:, i], dy[:, i]
        e = torch.exp(w[:, i])
        vdy = (vi * dyi).sum(-1, keepdim=True)                # [B, H, 1]
        ruk = (ri * uu * ki).sum(-1, keepdim=True)
        dr[:, i] = torch.einsum("bhkv,bhv->bhk", before[i], dyi) \
            + uu * ki * vdy
        dk[:, i] = uu * ri * vdy + torch.einsum("bhkv,bhv->bhk", g, vi)
        dv[:, i] = ruk * dyi + torch.einsum("bhkv,bhk->bhv", g, ki)
        dw[:, i] = e * (before[i] * g).sum(-1)
        du = du + (ri * ki * vdy).sum(0)
        g = e[..., None] * g + ri[..., :, None] * dyi[..., None, :]
    return dr, dk, dv, dw, du, g


def ref_ssd_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t):
    """The VJP of ``ref_ssd`` as an explicit reverse-time recurrence in fp32
    (no autograd).  x: [B, T, H, P]; dt: [B, T, H] (before softplus);
    a_log, d_skip: [H]; b, c: [B, T, N]; h0: [B, H, P, N] or None (zeros);
    dy: [B, T, H, P]; dh_t: [B, H, P, N] or None the cotangent of the
    final state.  Returns (dx, ddt, da_log, db, dc, dd_skip, dh0), all
    float32.  With d_t = softplus(dt_t), a = -e^{a_log}, g_t = e^{d_t a},
    h_t = g_t h_{t-1} + d_t x_t B_t^T, y_t = h_t C_t + D x_t and G_t the
    cotangent of h_t (the later steps' and y_t's):
        G_t   = g_{t+1} G_{t+1} + dy_t C_t^T   (G_{T-1} from dh_t)
        dC_t  = sum_h h_t^T dy_t,   dB_t = sum_h d_t G_t^T x_t
        dx_t  = D dy_t + d_t G_t B_t
        dd_t  = x_t^T G_t B_t + a g_t <G_t, h_{t-1}>
        ddt_t = dd_t sigmoid(dt_t),   da_log = a sum_{b,t} d_t g_t <G_t, h_{t-1}>
        dD    = sum_{b,t} dy_t . x_t,   dh0 = g_0 G_0.
    The states are kept from a forward sweep, never recovered by dividing
    by the decay."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    dtp = F.softplus(dtf)
    dec = torch.exp(dtp * a)                                   # [B, T, H]
    x, b, c, dy = x.float(), b.float(), c.float(), dy.float()
    s = torch.zeros((bsz, h, p, n), device=x.device) if h0 is None \
        else h0.float()
    states = [s]                                               # h_{t-1}
    for i in range(t):
        s = s * dec[:, i, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, i] * dtp[:, i, :, None], b[:, i])
        states.append(s)
    g = torch.zeros((bsz, h, p, n), device=x.device) if dh_t is None \
        else dh_t.float()
    dx = torch.empty_like(x)
    ddtp = torch.empty_like(dtp)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros((h,), device=x.device)
    for i in reversed(range(t)):
        g = g + dy[:, i, :, :, None] * c[:, i, None, None, :]
        dc[:, i] = torch.einsum("bhpn,bhp->bn", states[i + 1], dy[:, i])
        gb = torch.einsum("bhpn,bn->bhp", g, b[:, i])
        dx[:, i] = d_skip.float()[None, :, None] * dy[:, i] \
            + dtp[:, i, :, None] * gb
        db[:, i] = torch.einsum("bhpn,bhp->bn", g,
                                x[:, i] * dtp[:, i, :, None])
        q = (g * states[i]).sum((-1, -2))                      # [B, H]
        ddtp[:, i] = (gb * x[:, i]).sum(-1) + a * dec[:, i] * q
        da = da + (dtp[:, i] * dec[:, i] * q).sum(0)
        g = g * dec[:, i, :, None, None]
    dd = (dy * x).sum((0, 1, 3))
    return (dx, ddtp * torch.sigmoid(dtf), da * a, db, dc, dd, g)
