"""The Mamba2 SSD chunk scan: the wrapper of ``csrc/ssd.cu``.

``ssd_scan(x, dt, a_log, b, c, d_skip, h0=None, return_state=False)``:
x [B, T, H, P], dt [B, T, H] (before softplus), a_log / d_skip [H], b / c
[B, T, N] (shared by every head), h0 [B, H, P, N] (zeros when None) ->
y [B, T, H, P] float32, and with ``return_state`` also the final state
[B, H, P, N] float32.  Without ``h0`` it is the reference's Pallas kernel
(``src/repro/kernels/ssd.py``).  ``ssd_scan_bwd`` is its backward
(``csrc/ssd_bwd.cu``): the gradients of every input for the cotangents of
y and of the final state; ``ops.ssd_op`` joins the two into one
differentiable op.  The kernel's chunk is 128 steps and a
ragged T is masked in the last chunk; the result does not depend on the
chunking.

On the card: x, dt, b and c bf16, read in place through their batch and
time strides (the model passes slices of one projection; each row's last
dims must be contiguous); a_log and d_skip cast to float32 here; h0
float32 contiguous; P = N = 64.  x, b and c are loaded by
TMA, which needs each base address and each batch and time stride to be
a multiple of 16 bytes (``tma_stride_rule``; the stride of a dim of size 1
is never stepped and is not held to it).  A CPU tensor takes the plain
version in ``kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

SSD_SCAN = LaunchCounter("ssd_scan")
SSD_SCAN_BWD = LaunchCounter("ssd_scan_bwd")

HEAD_DIM = 64       # P
STATE_DIM = 64      # N
CHUNK = 128         # Q, fixed in the kernel


def _rows(a, name: str, inner: tuple) -> None:
    """Raise unless ``a`` is bf16 with its dims after time laid out
    contiguously (strides ``inner``); batch and time strides are free."""
    if a.dtype not in BF16:
        raise TypeError(f"ssd_scan {name}: dtype {a.dtype} not in "
                        f"{list(BF16)}")
    if tuple(a.stride()[2:]) != inner:
        raise ValueError(f"ssd_scan {name}: the dims after time must be "
                         f"contiguous, got strides {tuple(a.stride())}")


def tma_strides(name: str, shape, strides, itemsize: int,
                data_ptr: int) -> tuple:
    """The batch and time strides (elements) that the kernel's TMA map of
    an operand [B, T, ...] steps by.  Raise ValueError, naming the
    operand, unless its base address and each of those strides is a
    multiple of 16 bytes; a dim of size 1 is never stepped, and its stride
    is replaced by the next dim's extent (a multiple of 16 bytes too)."""
    if data_ptr % 16:
        raise ValueError(f"ssd_scan {name}: the TMA needs a 16-byte aligned "
                         f"base address, got offset {data_ptr % 16}")
    inner = 1
    for d in shape[2:]:
        inner *= d
    row = strides[1] if shape[1] > 1 else inner
    out = (strides[0] if shape[0] > 1 else row * shape[1], row)
    for dim, st in zip(("batch", "time"), out):
        if (st * itemsize) % 16:
            raise ValueError(f"ssd_scan {name}: the TMA needs the {dim} "
                             f"stride ({st} values of {itemsize} bytes) to "
                             f"be a multiple of 16 bytes")
    return out


def ssd_scan(x, dt, a_log, b, c, d_skip, *, h0=None,
             return_state: bool = False):
    """x: [B, T, H, P]; dt: [B, T, H]; a_log, d_skip: [H]; b, c: [B, T, N];
    h0: [B, H, P, N] or None -> y [B, T, H, P] float32 (, final state)."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes [B, T, H, P] x, got "
                         f"{tuple(x.shape)}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, t, h):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, expected "
                         f"{(bsz, t, h)}")
    if tuple(b.shape) != (bsz, t, n) or tuple(c.shape) != (bsz, t, n):
        raise ValueError(f"ssd_scan: b {tuple(b.shape)} / c {tuple(c.shape)}"
                         f", expected {(bsz, t, n)}")
    if tuple(a_log.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"ssd_scan: a_log {tuple(a_log.shape)} / d_skip "
                         f"{tuple(d_skip.shape)}, expected {(h,)}")
    if h0 is not None and tuple(h0.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)}, expected "
                         f"{(bsz, h, p, n)}")
    if on_cpu(x, dt, a_log, b, c, d_skip, h0):
        return ref.ref_ssd(x, dt, a_log, b, c, d_skip, h0=h0,
                           return_state=return_state)
    if p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"ssd_scan kernel takes P = {HEAD_DIM} and N = "
                         f"{STATE_DIM}, got P = {p}, N = {n}")
    _rows(x, "x", (p, 1))
    _rows(dt, "dt", (1,))
    _rows(b, "b", (1,))
    _rows(c, "c", (1,))
    xs, bs, cs = (tma_strides(name, a.shape, a.stride(), a.element_size(),
                              a.data_ptr())
                  for name, a in (("x", x), ("b", b), ("c", c)))
    if h0 is not None:
        require(h0, "h0", (torch.float32,), 4)
    a32 = a_log.float().contiguous()
    d32 = d_skip.float().contiguous()
    y = torch.empty((bsz, t, h, p), dtype=torch.float32, device=x.device)
    h_t = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if return_state else None
    status = lib("ssd").ssd_scan(
        ptr(x), ptr(dt), ptr(a32), ptr(b), ptr(c), ptr(d32), ptr(h0), ptr(y),
        ptr(h_t), bsz, t, h, p, n, *xs, dt.stride(0), dt.stride(1), *bs,
        *cs, stream(x))
    check(status, "ssd_scan")
    SSD_SCAN.inc()
    return (y, h_t) if return_state else y


CKPT_EVERY = 8      # R in csrc/ssd_bwd.cu: the backward's state checkpoints


def ssd_scan_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t):
    """The backward of ``ssd_scan``.  x, dy: [B, T, H, P]; dt: [B, T, H];
    a_log, d_skip: [H]; b, c: [B, T, N]; h0, dh_t: [B, H, P, N] or None
    (zeros) -> (dx, ddt, da_log, db, dc, dd_skip, dh0), all float32, in
    the shapes of the inputs (dh0 [B, H, P, N]).

    On the card x, dt, b and c are bf16 read in place through their batch
    and time strides, as the forward reads them (the dims after time
    contiguous; no TMA here, so no 16-byte rule); a_log and d_skip cast to
    float32, dy to float32 contiguous; h0 and dh_t float32 contiguous; P =
    N = 64.  The kernel's scratch (the state every ``CKPT_EVERY`` steps, B
    H ceil(T / 8) P N float32; dB and dC per head, [B, T, H, N] float32
    each; the per-(b, h) partials of da_log and D) is allocated here.  A
    CPU tensor takes ``ref.ref_ssd_bwd``; a CUDA tensor launches the kernel
    or raises."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_bwd takes [B, T, H, P] x, got "
                         f"{tuple(x.shape)}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if tuple(dt.shape) != (bsz, t, h):
        raise ValueError(f"ssd_scan_bwd: dt {tuple(dt.shape)}, expected "
                         f"{(bsz, t, h)}")
    if tuple(b.shape) != (bsz, t, n) or tuple(c.shape) != (bsz, t, n):
        raise ValueError(f"ssd_scan_bwd: b {tuple(b.shape)} / c "
                         f"{tuple(c.shape)}, expected {(bsz, t, n)}")
    if tuple(a_log.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"ssd_scan_bwd: a_log {tuple(a_log.shape)} / d_skip "
                         f"{tuple(d_skip.shape)}, expected {(h,)}")
    for name, a in (("h0", h0), ("dh_t", dh_t)):
        if a is not None and tuple(a.shape) != (bsz, h, p, n):
            raise ValueError(f"ssd_scan_bwd: {name} {tuple(a.shape)}, "
                             f"expected {(bsz, h, p, n)}")
    if on_cpu(x, dt, a_log, b, c, d_skip, h0, dy, dh_t):
        return ref.ref_ssd_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
    if p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"ssd_scan_bwd kernel takes P = {HEAD_DIM} and N = "
                         f"{STATE_DIM}, got P = {p}, N = {n}")
    _rows(x, "x", (p, 1))
    _rows(dt, "dt", (1,))
    _rows(b, "b", (1,))
    _rows(c, "c", (1,))
    for name, a in (("h0", h0), ("dh_t", dh_t)):
        if a is not None:
            require(a, name, (torch.float32,), 4)
    dev = x.device
    a32 = a_log.float().contiguous()
    d32 = d_skip.float().contiguous()
    dyf = dy.float().contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dx, ddt = empty(bsz, t, h, p), empty(bsz, t, h)
    da_log, dd = empty(h), empty(h)
    db, dc = empty(bsz, t, n), empty(bsz, t, n)
    dh0 = empty(bsz, h, p, n)
    dbh, dch = empty(bsz, t, h, n), empty(bsz, t, h, n)
    da_part, dd_part = empty(bsz, h), empty(bsz, h)
    ckpt = empty(bsz, h, -(-t // CKPT_EVERY), p, n)
    status = lib("ssd_bwd").ssd_scan_bwd(
        ptr(x), ptr(dt), ptr(a32), ptr(b), ptr(c), ptr(d32), ptr(h0),
        ptr(dyf), ptr(dh_t), ptr(dx), ptr(ddt), ptr(da_log), ptr(db),
        ptr(dc), ptr(dd), ptr(dh0), ptr(dbh), ptr(dch), ptr(da_part),
        ptr(dd_part), ptr(ckpt), bsz, t, h, p, n, x.stride(0), x.stride(1),
        dt.stride(0), dt.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), stream(x))
    check(status, "ssd_scan_bwd")
    SSD_SCAN_BWD.inc()
    return dx, ddt, da_log, db, dc, dd, dh0
