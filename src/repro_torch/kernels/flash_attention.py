"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

``flash_attention(q, k, v, causal=True, window=0)``: q [B, S, H, hd], k/v
[B, S, KV, hd] -> [B, S, H, hd] in q.dtype; query head h reads KV head
h // (H/KV), the scale is hd**-0.5, masked logits are -1e30, and query and
key positions both start at 0 (so Sq must equal Skv, as in the reference's
Pallas kernel).  On the card: bf16 only, hd 64, 80 or 128, no gradient (the
reference's kernel has no VJP either).

A CPU tensor takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.  ``contract_flash_attention`` holds every
refusal of the kernel route; the card's route and the meta route (the
output allocated on ``meta``, nothing launched or counted) both run it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, KernelRefused, LaunchCounter,
                                        addr, check, lib, on_cpu, ptr,
                                        require, stream)

FLASH_ATTENTION = LaunchCounter("flash_attention")

HEAD_DIMS = (64, 80, 128)     # the kernel's template instances


def _shapes(q, k, v, window: int) -> None:
    """The refusals of every route: shapes, heads, window."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise KernelRefused(f"flash_attention takes 4-dim q, k, v, got "
                            f"{tuple(q.shape)}, {tuple(k.shape)}, "
                            f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or \
            k.shape[3] != hd:
        raise KernelRefused(f"flash_attention: k {tuple(k.shape)} / v "
                            f"{tuple(v.shape)} do not match q "
                            f"{tuple(q.shape)}")
    if sq != skv:
        raise KernelRefused(f"flash_attention takes query and key positions "
                            f"both from 0: Sq ({sq}) must equal Skv ({skv})")
    if kvh == 0 or h % kvh:
        raise KernelRefused(f"flash_attention: {h} query heads over {kvh} KV "
                            f"heads")
    if window < 0:
        raise KernelRefused(f"flash_attention: window {window} < 0")


def contract_flash_attention(q, k, v, window: int = 0) -> None:
    """Raise unless the kernel takes q [B, S, H, hd], k / v [B, S, KV, hd]:
    the shapes of every route, bf16, contiguous, 16-byte aligned, hd in
    ``HEAD_DIMS``, no gradient wanted."""
    _shapes(q, k, v, window)
    hd = q.shape[3]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise KernelRefused("flash_attention has no backward kernel: call it "
                            "under torch.no_grad() / inference_mode")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t, name, BF16, 4)
        if addr(t) % 16:
            raise KernelRefused(f"flash_attention {name}: not 16-byte aligned")
    if hd not in HEAD_DIMS:
        raise KernelRefused(f"flash_attention kernel takes head_dim in "
                            f"{HEAD_DIMS}, got {hd}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, S, H, hd]; k/v: [B, S, KV, hd] -> [B, S, H, hd] q.dtype."""
    _shapes(q, k, v, window)
    if on_cpu(q, k, v):
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    contract_flash_attention(q, k, v, window)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    out = torch.empty_like(q)
    if q.numel() == 0 or q.is_meta:
        return out
    status = lib("flash_attention").flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), b, sq, h, kvh, hd, int(causal),
        int(window), stream(q))
    check(status, "flash_attention")
    FLASH_ATTENTION.inc()
    return out
