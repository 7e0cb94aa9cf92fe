"""Mamba2 (SSD) block: the sequence path (train/prefill) and the recurrent
single-step decode path — the zamba2 backbone, in PyTorch.

SSD recurrence per head (P = head_dim, N = d_state, scalar decay per head):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)        h: [P, N]
    y_t = h_t @ C_t + D * x_t
The reference computes the sequence path with chunked jnp matmuls
(``ssd_chunked``); here ``ssd_chunked`` calls ``kernels.ops.ssd_op``, the
same function: the Hopper SSD kernel on a CUDA tensor, reading x, B and C
in place from the convolved projection, its plain version on a CPU tensor
or on the "xla" route.  ``mamba_decode`` stays plain tensor code, with the
reference's own single-step formula.  Parameters and states keep the
reference's layouts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.ops import kernel_route, ssd_op
from repro_torch.models.layers import dense_init, rms_norm

CONV_K = 4  # depthwise causal conv width


class MambaParams(NamedTuple):
    in_proj: torch.Tensor    # [d, 2*d_in + 2*N + H]  -> z, x, B, C, dt
    conv_w: torch.Tensor     # [K, d_in + 2*N] depthwise
    conv_b: torch.Tensor     # [d_in + 2*N]
    a_log: torch.Tensor      # [H] log(-A)
    d_skip: torch.Tensor     # [H]
    dt_bias: torch.Tensor    # [H]
    norm: torch.Tensor       # [d_in] gated RMSNorm scale
    out_proj: torch.Tensor   # [d_in, d]


class MambaState(NamedTuple):
    h: torch.Tensor          # [B, H, P, N] SSM state
    conv: torch.Tensor       # [B, K-1, d_in + 2*N] conv tail


def dims(cfg):
    d_in = cfg.ssm.expand * cfg.d_model
    n_heads = d_in // cfg.ssm.head_dim
    return d_in, n_heads, cfg.ssm.d_state, cfg.ssm.head_dim


def init_mamba_params(gen: torch.Generator, cfg, lead=(), dtype=torch.float32,
                      device="cuda") -> MambaParams:
    """The reference's distributions, with leading dims ``lead`` (the layer
    stack): N(0, 1/fan_in) projections, N(0, 0.1^2) conv taps, zero conv
    bias and dt bias, a_log = log(linspace(1, 16, H)), unit D and norm."""
    d_in, h, n, p = dims(cfg)
    d = cfg.d_model
    conv_ch = d_in + 2 * n

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=dtype, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    return MambaParams(
        in_proj=dense_init(gen, (*lead, d, 2 * d_in + 2 * n + h), -2,
                           dtype=dtype, device=device),
        conv_w=(torch.randn((*lead, CONV_K, conv_ch), generator=gen,
                            device=device) * 0.1).to(dtype),
        conv_b=full(0.0, conv_ch),
        a_log=a_log.expand(*lead, h).to(dtype).contiguous(),
        d_skip=full(1.0, h),
        dt_bias=full(0.0, h),
        norm=full(1.0, d_in),
        out_proj=dense_init(gen, (*lead, d_in, d), -2, dtype=dtype,
                            device=device),
    )


def _split_proj(cfg, proj):
    d_in, h, n, p = dims(cfg)
    z, xbc_dt = torch.split(proj, [d_in, proj.shape[-1] - d_in], dim=-1)
    xbc, dt = torch.split(xbc_dt, [d_in + 2 * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, w, b, tail=None):
    """Depthwise causal conv along time.  xbc: [B, T, C]; tail: [B, K-1, C]."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    ct = torch.promote_types(tail.dtype, xbc.dtype)    # jnp.concatenate's
    xp = torch.cat([tail.to(ct), xbc.to(ct)], dim=1)
    t = xbc.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(k)) + b
    return F.silu(out), xp[:, -(k - 1):]


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int, h0=None, *,
                use_kernel: bool = True):
    """SSD over a sequence.  x: [B,T,H,P]; dt: [B,T,H]; b,c: [B,T,N].
    Returns (y [B,T,H,P] float32, h_final [B,H,P,N] float32).  The result
    does not depend on ``chunk`` (the kernel's chunk is its own); x, b and c
    may be strided slices of one tensor.  ``use_kernel=False`` takes the
    plain version."""
    scan = ssd_op if use_kernel else ref.ref_ssd
    return scan(x, dt, a_log, b, c, d_skip, h0, return_state=True)


def mamba_block(p: MambaParams, cfg, x, state: Optional[MambaState] = None):
    """Sequence path.  x: [B, T, d] -> (y, final MambaState)."""
    bsz, t, d = x.shape
    d_in, h, n, pd = dims(cfg)
    z, xbc, dt = _split_proj(cfg, x @ p.in_proj)
    conv_tail = state.conv if state is not None else None
    xbc, tail = _causal_conv(xbc, p.conv_w, p.conv_b, conv_tail)
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, t, h, pd)
    dt = dt + p.dt_bias
    h0 = state.h if state is not None else None
    y, h_t = ssd_chunked(xs, dt, p.a_log, b, c, p.d_skip, cfg.ssm.chunk, h0,
                         use_kernel=kernel_route(cfg))
    y = y.reshape(bsz, t, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.out_proj, MambaState(h_t, tail)


def mamba_decode(p: MambaParams, cfg, x, state: MambaState):
    """Single-token recurrent path (plain tensor code).  x: [B, 1, d].  The
    conv tail and the step run in the state's type (float32), as the
    reference's type promotion has them."""
    bsz = x.shape[0]
    d_in, h, n, pd = dims(cfg)
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p.in_proj)
    # conv over stored tail + current input
    ct = torch.promote_types(state.conv.dtype, xbc.dtype)
    xp = torch.cat([state.conv.to(ct), xbc[:, None].to(ct)], dim=1)  # [B,K,C]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", xp, p.conv_w.to(ct))
                      + p.conv_b.to(ct))
    xs, b, c = torch.split(conv_out, [d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, h, pd)
    dt = F.softplus((dt + p.dt_bias).float())                    # [B,H]
    a = -torch.exp(p.a_log.float())
    dec = torch.exp(dt * a[None])                                # [B,H]
    upd = torch.einsum("bhp,bk->bhpk", xs.float() * dt[..., None], b.float())
    hnew = state.h * dec[..., None, None] + upd
    y = torch.einsum("bhpk,bk->bhp", hnew, c.float())
    y = y + xs.float() * p.d_skip.float()[None, :, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None]), p.norm, cfg.norm_eps)
    return y @ p.out_proj, MambaState(hnew, xp[:, 1:])


def init_mamba_state(cfg, batch, dtype=torch.float32,
                     device="cuda") -> MambaState:
    d_in, h, n, pd = dims(cfg)
    return MambaState(
        torch.zeros((batch, h, pd, n), device=device),
        torch.zeros((batch, CONV_K - 1, d_in + 2 * n), dtype=dtype,
                    device=device))

