"""The RWKV6 WKV recurrence: the wrapper of ``csrc/rwkv6.cu``.

``rwkv6_wkv(r, k, v, w, u, s0=None, return_state=False)``:
r/k/v/w [B, T, H, hd] (w the log decay), u [H, hd], s0 [B, H, hd, hd]
(zeros when None) -> y [B, T, H, hd] float32, and with ``return_state``
also the final state [B, H, hd, hd] float32.  ``rwkv6_wkv_bwd`` is its
backward (``csrc/rwkv6_bwd.cu``, chunked over 64 steps, the state
products on the tensor cores): the gradients of r, k, v, w, u and s0
for the cotangents of y and of the final state; ``ops.rwkv6_op`` joins the
two into one differentiable op.  Without ``s0`` it is the
reference's Pallas kernel (``src/repro/kernels/rwkv6.py``); with it, the
same recurrence continued from a cached state (one decode step is T = 1).
From T = 64 the kernel runs the chunked form on the tensor cores, in
chunks of 64 steps (the last one ragged); a shorter T runs a step loop.

On the card: r, k and v bf16; w float32 (the model forms the log decay in
float32, and a bf16 w would compound over T); u and s0 float32 (u is cast
here); hd 64; every tensor contiguous.  From T = 64, r, k, v and w are loaded by TMA, which
needs each base address to be a multiple of 16 bytes (``tma_base_rule``;
the rows of a contiguous [B, T, H, 64] tensor are then too).  A CPU tensor
takes the plain version in ``kernels.ref``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, aligned16,
                                        check, lib, on_cpu, ptr, require,
                                        stream)

RWKV6_WKV = LaunchCounter("rwkv6_wkv")
RWKV6_WKV_BWD = LaunchCounter("rwkv6_wkv_bwd")

HEAD_DIM = 64       # the kernel's one instance
CHUNK = 64          # Q: from this T on, the chunked kernel (TMA loads)


def tma_base_rule(name: str, data_ptr: int) -> None:
    """Raise ValueError, naming the operand, unless its base address is a
    multiple of 16 bytes, as the TMA's loads need."""
    if data_ptr % 16:
        raise ValueError(f"rwkv6_wkv {name}: the TMA needs a 16-byte aligned "
                         f"base address, got offset {data_ptr % 16}")


def rwkv6_wkv(r, k, v, w, u, *, s0=None, return_state: bool = False):
    """r/k/v/w: [B, T, H, hd]; u: [H, hd]; s0: [B, H, hd, hd] or None ->
    y [B, T, H, hd] float32 (, final state [B, H, hd, hd] float32)."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv takes [B, T, H, hd] r, got "
                         f"{tuple(r.shape)}")
    b, t, h, hd = r.shape
    for name, a in (("k", k), ("v", v), ("w", w)):
        if tuple(a.shape) != tuple(r.shape):
            raise ValueError(f"rwkv6_wkv: {name} {tuple(a.shape)} does not "
                             f"match r {tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)}, expected {(h, hd)}")
    if s0 is not None and tuple(s0.shape) != (b, h, hd, hd):
        raise ValueError(f"rwkv6_wkv: s0 {tuple(s0.shape)}, expected "
                         f"{(b, h, hd, hd)}")
    if on_cpu(r, k, v, w, u, s0):
        return ref.ref_rwkv6(r, k, v, w, u, s0=s0, return_state=return_state)
    for name, a in (("r", r), ("k", k), ("v", v)):
        require(a, name, BF16, 4)
    require(w, "w", (torch.float32,), 4)
    if s0 is not None:
        require(s0, "s0", (torch.float32,), 4)
    if hd != HEAD_DIM:
        raise ValueError(f"rwkv6_wkv kernel takes head_dim {HEAD_DIM}, got "
                         f"{hd}")
    if t >= CHUNK:
        for name, a in (("r", r), ("k", k), ("v", v), ("w", w)):
            tma_base_rule(name, a.data_ptr())
    uf = u.float().contiguous()
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_t = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if return_state else None
    status = lib("rwkv6").rwkv6_wkv(
        ptr(r), ptr(k), ptr(v), ptr(w), ptr(uf), ptr(s0), ptr(y), ptr(s_t),
        b, t, h, hd, stream(r))
    check(status, "rwkv6_wkv")
    RWKV6_WKV.inc()
    return (y, s_t) if return_state else y


BWD_CHUNK = 64      # Q in csrc/rwkv6_bwd.cu: the backward's chunk


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_t):
    """The backward of ``rwkv6_wkv``.  r/k/v/w, dy: [B, T, H, hd]; u: [H,
    hd]; s0, ds_t: [B, H, hd, hd] or None (zeros) -> (dr, dk, dv, dw, du
    [H, hd], ds0 [B, H, hd, hd]), all float32.

    On the card r, k and v are bf16, w float32 (as the forward takes
    them), dy, s0 and ds_t float32 (dy is cast here), hd 64, every tensor
    contiguous and r, k, v and w 16-byte aligned (``tma_base_rule``: they
    are loaded in 16-byte vectors, as are dy, s0 and ds_t, each copied first
    when its base is not 16-byte aligned).  The kernels' scratch is allocated
    here: each chunk's entering state and leaving cotangent ([ceil(T /
    64), 2, B, H, hd, hd] float32: 128 MiB at 4 x 2048 x 32 heads), its
    decay per row ([ceil(T / 64), B, H, hd]) and du's per-(b, chunk)
    partials.  A CPU tensor takes ``ref.ref_rwkv6_bwd``; a CUDA tensor
    launches the kernels or raises."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv_bwd takes [B, T, H, hd] r, got "
                         f"{tuple(r.shape)}")
    b, t, h, hd = r.shape
    for name, a in (("k", k), ("v", v), ("w", w), ("dy", dy)):
        if tuple(a.shape) != tuple(r.shape):
            raise ValueError(f"rwkv6_wkv_bwd: {name} {tuple(a.shape)} does "
                             f"not match r {tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"rwkv6_wkv_bwd: u {tuple(u.shape)}, expected "
                         f"{(h, hd)}")
    for name, a in (("s0", s0), ("ds_t", ds_t)):
        if a is not None and tuple(a.shape) != (b, h, hd, hd):
            raise ValueError(f"rwkv6_wkv_bwd: {name} {tuple(a.shape)}, "
                             f"expected {(b, h, hd, hd)}")
    if on_cpu(r, k, v, w, u, s0, dy, ds_t):
        return ref.ref_rwkv6_bwd(r, k, v, w, u, s0, dy, ds_t)
    for name, a in (("r", r), ("k", k), ("v", v)):
        require(a, name, BF16, 4)
    require(w, "w", (torch.float32,), 4)
    for name, a in (("s0", s0), ("ds_t", ds_t)):
        if a is not None:
            require(a, name, (torch.float32,), 4)
    if hd != HEAD_DIM:
        raise ValueError(f"rwkv6_wkv_bwd kernel takes head_dim {HEAD_DIM}, "
                         f"got {hd}")
    dev = r.device
    uf = u.float().contiguous()
    dyf = aligned16(dy.float().contiguous())
    s0, ds_t = aligned16(s0), aligned16(ds_t)
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w)):
        tma_base_rule(name, a.data_ptr())
    chunks = -(-t // BWD_CHUNK)
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=torch.float32, device=dev)
                      for _ in range(4))
    du = torch.empty((h, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    states = torch.empty((chunks, 2, b, h, hd, hd), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((chunks, b, h, hd), dtype=torch.float32, device=dev)
    du_part = torch.empty((b, chunks, h, hd), dtype=torch.float32,
                          device=dev)
    status = lib("rwkv6_bwd").rwkv6_wkv_bwd(
        ptr(r), ptr(k), ptr(v), ptr(w), ptr(uf), ptr(s0), ptr(dyf),
        ptr(ds_t), ptr(dr), ptr(dk), ptr(dv), ptr(dw), ptr(du), ptr(ds0),
        ptr(states), ptr(decay), ptr(du_part), b, t, h, hd, stream(r))
    check(status, "rwkv6_wkv_bwd")
    RWKV6_WKV_BWD.inc()
    return dr, dk, dv, dw, du, ds0
