"""Shared primitives: RMS norm, RoPE, the dense initializer, the dense FFN."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import gelu


def dense_init(gen: torch.Generator, shape, scale_axis: int = 0,
               dtype=torch.float32, device="cuda"):
    """N(0, 1/shape[scale_axis]), as the reference's ``dense_init``.  The
    draws are scaled in place: one fp32 transient of the leaf's size, not
    two (a [128, 5120, 8192] expert leaf is 21.5 GB in fp32).  On
    ``meta`` it draws nothing."""
    if torch.device(device).type == "meta":      # the dry run: no draws
        return torch.empty(shape, dtype=dtype, device=device)
    scale = shape[scale_axis] ** -0.5
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(
        dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(q, k, positions, theta: float = 10_000.0):
    """Rotary embeddings.  q/k: [..., S, H, hd]; positions: [..., S]."""
    hd = q.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=q.device) / hd)
    ang = positions[..., :, None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]

    def rot(x):
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def ffn_branch(x, w_in, w_up, w_out, ffn_type: str):
    """The dense-FFN math: swiglu or gelu (tanh form)."""
    h = x @ w_in
    if ffn_type == "swiglu":
        h = F.silu(h) * (x @ w_up)
    else:
        h = gelu(h)
    return h @ w_out


def ffn_parallel(x, w_in, w_up, w_out, ffn_type: str, f: int, layout):
    """The dense FFN of hidden width ``f`` on replicated x, with w_in /
    w_up column-parallel and w_out row-parallel over ``layout``'s
    model-parallel group where they are split (one all-reduce of the
    partial output, ``layout.reduce_out``); whole weights compute whole.
    On a Megatron-SP view x [B, S / n, d] is this rank's sequence slice:
    split weights take it gathered whole and reduce-scatter the partial
    output back to the slice; whole weights compute on the slice."""
    split = layout is not None and w_out.shape[-2] != f
    if split:
        x = layout.whole_seq(x)
    y = ffn_branch(x, w_in, w_up, w_out, ffn_type)
    if split:
        y = layout.reduce_out(y)
    return y
