"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix,
in PyTorch.

Recurrence per head (hd-dim keys/values, diagonal data-dependent decay w_t):
    y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
The reference computes the sequence path with a chunk-vectorized jnp scan
(``wkv_chunked``); here ``wkv_chunked`` calls ``kernels.ops.rwkv6_op``, the
same function: the Hopper WKV kernel on a CUDA tensor (with the initial
state of a decode step), its plain version on a CPU tensor or on the
"xla" route.  On the kernel route it is differentiable through the WKV
backward kernel (training); the plain route differentiates the plain
recurrence with autograd.  Decode is the same call at T = 1 from the
cached state, as in the reference.  Parameters and states keep the
reference's layouts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.ops import kernel_route, rwkv6_op
from repro_torch.models.layers import dense_init, rms_norm

LORA_R = 32  # low-rank size of the data-dependent decay


class RWKVParams(NamedTuple):
    # time-mix
    mu: torch.Tensor        # [5, d]  token-shift lerp weights for w,k,v,r,g
    w0: torch.Tensor        # [d]     decay base
    w_a: torch.Tensor       # [d, R]  decay lora
    w_b: torch.Tensor       # [R, d]
    wk: torch.Tensor        # [d, d]
    wv: torch.Tensor        # [d, d]
    wr: torch.Tensor        # [d, d]
    wg: torch.Tensor        # [d, d]
    u: torch.Tensor         # [d]     bonus
    wo: torch.Tensor        # [d, d]
    ln_x: torch.Tensor      # [d]     group-norm-ish scale on the head outputs
    # channel-mix
    mu_c: torch.Tensor      # [2, d]
    ck: torch.Tensor        # [d, f]
    cv: torch.Tensor        # [f, d]
    cr: torch.Tensor        # [d, d]


class RWKVState(NamedTuple):
    s: torch.Tensor         # [B, H, hd, hd] wkv state
    x_tm: torch.Tensor      # [B, d] last token (time-mix shift)
    x_cm: torch.Tensor      # [B, d] last token (channel-mix shift)


def init_rwkv_params(gen: torch.Generator, cfg, lead=(), dtype=torch.float32,
                     device="cuda") -> RWKVParams:
    """The reference's distributions, with leading dims ``lead`` (the layer
    stack): N(0, 1/fan_in) projections, N(0, 0.01^2) decay lora, lerp
    weights 0.5, decay base -2, zero bonus u, unit norm scale."""
    d, f = cfg.d_model, cfg.d_ff

    def dense(*shape):
        return dense_init(gen, (*lead, *shape), -2, dtype=dtype,
                          device=device)

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=dtype, device=device)

    def small(*shape):
        return (torch.randn((*lead, *shape), generator=gen, device=device)
                * 0.01).to(dtype)

    return RWKVParams(
        mu=full(0.5, 5, d), w0=full(-2.0, d), w_a=small(d, LORA_R),
        w_b=small(LORA_R, d), wk=dense(d, d), wv=dense(d, d),
        wr=dense(d, d), wg=dense(d, d), u=full(0.0, d), wo=dense(d, d),
        ln_x=full(1.0, d), mu_c=full(0.5, 2, d), ck=dense(d, f),
        cv=dense(f, d), cr=dense(d, d))


def _heads(cfg):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def _tm_projections(p: RWKVParams, cfg, x, x_prev):
    """x: [B,T,d]; x_prev: same, shifted by one (data-dependent lerp).
    The log decay lw is float32, as the reference's promotion makes it."""
    def mix(i):
        return x + (x_prev - x) * p.mu[i]
    w_in, xk, xv, xr, xg = (mix(i) for i in range(5))
    # data-dependent decay (lora): w in (0,1), log-decay lw < 0
    lw = -torch.exp(p.w0.float() + torch.tanh(w_in.float() @ p.w_a.float())
                    @ p.w_b.float())
    k, v = xk @ p.wk, xv @ p.wv
    r, g = xr @ p.wr, F.silu(xg @ p.wg)
    return lw, k, v, r, g


def wkv_chunked(r, k, v, lw, u, n_heads, hd, chunk, s0=None, *,
                use_kernel: bool = True):
    """WKV over a sequence.  r/k/v: [B,T,d]; lw: [B,T,d] log decays; s0:
    [B,H,hd,hd] or None.  Returns (y [B,T,d] float32, s_final [B,H,hd,hd]).
    The heads are a [B,T,H,hd] view (no copy).  The result does not depend
    on ``chunk`` (the kernel stages its own).  ``use_kernel=False`` takes
    the plain version."""
    bsz, t, d = r.shape

    def heads(a):
        return a.reshape(bsz, t, n_heads, hd)
    wkv = rwkv6_op if use_kernel else ref.ref_rwkv6
    y, s_t = wkv(heads(r), heads(k), heads(v), heads(lw),
                 u.reshape(n_heads, hd), s0, return_state=True)
    return y.reshape(bsz, t, d), s_t


def time_mix(p: RWKVParams, cfg, x, state: Optional[RWKVState] = None):
    """x: [B,T,d] -> (y [B,T,d], final wkv state, last token)."""
    bsz, t, d = x.shape
    h, hd = _heads(cfg)
    x_last = state.x_tm[:, None].to(x.dtype) if state is not None \
        else torch.zeros_like(x[:, :1])
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)
    lw, k, v, r, g = _tm_projections(p, cfg, x, x_prev)
    s0 = state.s if state is not None else None
    y, s_t = wkv_chunked(r, k, v, lw, p.u, h, hd, cfg.ssm.chunk, s0,
                         use_kernel=kernel_route(cfg))
    y = rms_norm(y.to(x.dtype) * g, p.ln_x, cfg.norm_eps)
    return y @ p.wo, s_t, x[:, -1]


def channel_mix(p: RWKVParams, x, x_last=None):
    first = torch.zeros_like(x[:, :1]) if x_last is None \
        else x_last[:, None].to(x.dtype)
    x_prev = torch.cat([first, x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p.mu_c[0]
    xr = x + (x_prev - x) * p.mu_c[1]
    kk = torch.square(torch.relu(xk @ p.ck))
    return torch.sigmoid(xr @ p.cr) * (kk @ p.cv), x[:, -1]


def init_rwkv_state(cfg, batch, device="cuda") -> RWKVState:
    h, hd = _heads(cfg)
    return RWKVState(
        torch.zeros((batch, h, hd, hd), device=device),
        torch.zeros((batch, cfg.d_model), device=device),
        torch.zeros((batch, cfg.d_model), device=device))
