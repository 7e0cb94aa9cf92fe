"""The Mamba2 SSD chunk scan: the wrapper of ``csrc/ssd.cu``.

``ssd_scan(x, dt, a_log, b, c, d_skip, h0=None, return_state=False)``:
x [B, T, H, P], dt [B, T, H] (before softplus), a_log / d_skip [H], b / c
[B, T, N] (shared by every head), h0 [B, H, P, N] (zeros when None) ->
y [B, T, H, P] float32, and with ``return_state`` also the final state
[B, H, P, N] float32.  Without ``h0`` it is the reference's Pallas kernel
(``src/repro/kernels/ssd.py``).  ``ssd_scan_bwd`` is its backward
(``csrc/ssd_bwd.cu``, chunked over 64 steps on the tensor cores): the
gradients of every input for the cotangents of y and of the final state;
``ops.ssd_op`` joins the two into one differentiable op.  The forward's
chunk is 128 steps and a ragged T is masked in the last chunk; the result
does not depend on the chunking.

On the card: x, dt, b and c bf16, read in place through their batch and
time strides (the model passes slices of one projection; each row's last
dims must be contiguous); a_log and d_skip cast to float32 here; h0
float32 contiguous; P = N = 64.  x, b and c are loaded by
TMA, which needs each base address and each batch and time stride to be
a multiple of 16 bytes (``tma_stride_rule``; the stride of a dim of size 1
is never stepped and is not held to it).  A CPU tensor takes the plain
version in ``kernels.ref``; a CUDA tensor launches the kernel or raises.
``contract_ssd_scan`` / ``contract_ssd_scan_bwd`` hold each kernel's
refusals; the card's route and the meta route (outputs and scratch
allocated on ``meta``, nothing launched or counted) both run them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, KernelRefused, LaunchCounter,
                                        addr, aligned16, check, lib, on_cpu,
                                        ptr, require, stream)

SSD_SCAN = LaunchCounter("ssd_scan")
SSD_SCAN_BWD = LaunchCounter("ssd_scan_bwd")

HEAD_DIM = 64       # P
STATE_DIM = 64      # N
CHUNK = 128         # Q, fixed in the kernel


def _rows(a, name: str, inner: tuple) -> None:
    """Raise unless ``a`` is bf16 with its dims after time laid out
    contiguously (strides ``inner``); batch and time strides are free."""
    if a.dtype not in BF16:
        raise KernelRefused(f"ssd_scan {name}: dtype {a.dtype} not in "
                            f"{list(BF16)}")
    if tuple(a.stride()[2:]) != inner:
        raise KernelRefused(f"ssd_scan {name}: the dims after time must be "
                            f"contiguous, got strides {tuple(a.stride())}")


def tma_strides(name: str, shape, strides, itemsize: int,
                data_ptr: int) -> tuple:
    """The batch and time strides (elements) that the kernel's TMA map of
    an operand [B, T, ...] steps by.  Raise ValueError, naming the
    operand, unless its base address and each of those strides is a
    multiple of 16 bytes; a dim of size 1 is never stepped, and its stride
    is replaced by the next dim's extent (a multiple of 16 bytes too)."""
    if data_ptr % 16:
        raise KernelRefused(f"ssd_scan {name}: the TMA needs a 16-byte "
                            f"aligned base address, got offset "
                            f"{data_ptr % 16}")
    inner = 1
    for d in shape[2:]:
        inner *= d
    row = strides[1] if shape[1] > 1 else inner
    out = (strides[0] if shape[0] > 1 else row * shape[1], row)
    for dim, st in zip(("batch", "time"), out):
        if (st * itemsize) % 16:
            raise KernelRefused(f"ssd_scan {name}: the TMA needs the {dim} "
                                f"stride ({st} values of {itemsize} bytes) to "
                                f"be a multiple of 16 bytes")
    return out


def _shapes(x, dt, a_log, b, c, d_skip, h0) -> None:
    """The forward's refusals on every route: the operands' shapes."""
    if x.dim() != 4:
        raise KernelRefused(f"ssd_scan takes [B, T, H, P] x, got "
                            f"{tuple(x.shape)}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, t, h):
        raise KernelRefused(f"ssd_scan: dt {tuple(dt.shape)}, expected "
                            f"{(bsz, t, h)}")
    if tuple(b.shape) != (bsz, t, n) or tuple(c.shape) != (bsz, t, n):
        raise KernelRefused(f"ssd_scan: b {tuple(b.shape)} / c "
                            f"{tuple(c.shape)}, expected {(bsz, t, n)}")
    if tuple(a_log.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise KernelRefused(f"ssd_scan: a_log {tuple(a_log.shape)} / d_skip "
                            f"{tuple(d_skip.shape)}, expected {(h,)}")
    if h0 is not None and tuple(h0.shape) != (bsz, h, p, n):
        raise KernelRefused(f"ssd_scan: h0 {tuple(h0.shape)}, expected "
                            f"{(bsz, h, p, n)}")


def contract_ssd_scan(x, dt, a_log, b, c, d_skip, h0=None) -> tuple:
    """Raise unless the SSD kernel takes these operands: the shapes of
    every route, P = N = 64, x / dt / b / c bf16 with their dims after
    time contiguous, x, b and c under ``tma_strides``, h0 float32
    contiguous.  Returns the (batch, time) strides of x, b and c."""
    _shapes(x, dt, a_log, b, c, d_skip, h0)
    p, n = x.shape[3], b.shape[-1]
    if p != HEAD_DIM or n != STATE_DIM:
        raise KernelRefused(f"ssd_scan kernel takes P = {HEAD_DIM} and N = "
                            f"{STATE_DIM}, got P = {p}, N = {n}")
    _rows(x, "x", (p, 1))
    _rows(dt, "dt", (1,))
    _rows(b, "b", (1,))
    _rows(c, "c", (1,))
    xs, bs, cs = (tma_strides(name, a.shape, a.stride(), a.element_size(),
                              addr(a))
                  for name, a in (("x", x), ("b", b), ("c", c)))
    if h0 is not None:
        require(h0, "h0", (torch.float32,), 4)
    return xs, bs, cs


def ssd_scan(x, dt, a_log, b, c, d_skip, *, h0=None,
             return_state: bool = False):
    """x: [B, T, H, P]; dt: [B, T, H]; a_log, d_skip: [H]; b, c: [B, T, N];
    h0: [B, H, P, N] or None -> y [B, T, H, P] float32 (, final state)."""
    _shapes(x, dt, a_log, b, c, d_skip, h0)
    if on_cpu(x, dt, a_log, b, c, d_skip, h0):
        return ref.ref_ssd(x, dt, a_log, b, c, d_skip, h0=h0,
                           return_state=return_state)
    xs, bs, cs = contract_ssd_scan(x, dt, a_log, b, c, d_skip, h0)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    a32 = a_log.float().contiguous()
    d32 = d_skip.float().contiguous()
    y = torch.empty((bsz, t, h, p), dtype=torch.float32, device=x.device)
    h_t = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if return_state else None
    if x.is_meta:
        return (y, h_t) if return_state else y
    status = lib("ssd").ssd_scan(
        ptr(x), ptr(dt), ptr(a32), ptr(b), ptr(c), ptr(d32), ptr(h0), ptr(y),
        ptr(h_t), bsz, t, h, p, n, *xs, dt.stride(0), dt.stride(1), *bs,
        *cs, stream(x))
    check(status, "ssd_scan")
    SSD_SCAN.inc()
    return (y, h_t) if return_state else y


BWD_CHUNK = 64      # Q in csrc/ssd_bwd.cu: the backward's chunk
BWD_HEADS = 8       # kHeads in csrc/ssd_bwd.cu: the heads of a block


def ssd_scan_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t):
    """The backward of ``ssd_scan``.  x, dy: [B, T, H, P]; dt: [B, T, H];
    a_log, d_skip: [H]; b, c: [B, T, N]; h0, dh_t: [B, H, P, N] or None
    (zeros) -> (dx, ddt, da_log, db, dc, dd_skip, dh0), all float32, in
    the shapes of the inputs (dh0 [B, H, P, N]).

    On the card x, dt, b and c are bf16 read in place through their batch
    and time strides, as the forward reads them (the dims after time
    contiguous; x, b and c under the forward's 16-byte rule, loaded in
    16-byte vectors); a_log and d_skip cast to float32, dy to float32
    contiguous; h0 and dh_t float32 contiguous; P = N = 64.  dy, h0 and
    dh_t are loaded in 16-byte vectors: one whose base is not 16-byte
    aligned is copied first.  The kernels'
    scratch is allocated here: each chunk's entering state and leaving
    cotangent ([ceil(T / 64), 2, B, H, P, N] float32: 256 MiB at 4 x 2048
    x 64 heads), its decay ([ceil(T / 64), B, H]), dB and dC of each group of
    ``BWD_HEADS`` heads ([B, T, ceil(H / 8), 2, N] float32: 32 MiB) and
    the per-(b, chunk, h) partials of da_log and D.  A CPU tensor takes
    ``ref.ref_ssd_bwd``; a CUDA tensor launches the kernels or raises."""
    _bwd_shapes(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
    if on_cpu(x, dt, a_log, b, c, d_skip, h0, dy, dh_t):
        return ref.ref_ssd_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
    contract_ssd_scan_bwd(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    h0, dh_t = aligned16(h0), aligned16(dh_t)
    dev = x.device
    a32 = a_log.float().contiguous()
    d32 = d_skip.float().contiguous()
    dyf = aligned16(dy.float().contiguous())

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    chunks, groups = -(-t // BWD_CHUNK), -(-h // BWD_HEADS)
    dx, ddt = empty(bsz, t, h, p), empty(bsz, t, h)
    da_log, dd = empty(h), empty(h)
    db, dc = empty(bsz, t, n), empty(bsz, t, n)
    dh0 = empty(bsz, h, p, n)
    states = empty(chunks, 2, bsz, h, p, n)
    decay = empty(chunks, bsz, h)
    part = empty(bsz, t, groups, 2, n)
    scal = empty(bsz, chunks, h, 2)
    if x.is_meta:
        return dx, ddt, da_log, db, dc, dd, dh0
    status = lib("ssd_bwd").ssd_scan_bwd(
        ptr(x), ptr(dt), ptr(a32), ptr(b), ptr(c), ptr(d32), ptr(h0),
        ptr(dyf), ptr(dh_t), ptr(dx), ptr(ddt), ptr(da_log), ptr(db),
        ptr(dc), ptr(dd), ptr(dh0), ptr(states), ptr(decay), ptr(part),
        ptr(scal), bsz, t, h, p, n, x.stride(0), x.stride(1),
        dt.stride(0), dt.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), stream(x))
    check(status, "ssd_scan_bwd")
    SSD_SCAN_BWD.inc()
    return dx, ddt, da_log, db, dc, dd, dh0


def _bwd_shapes(x, dt, a_log, b, c, d_skip, h0, dy, dh_t) -> None:
    """The backward's refusals on every route: the operands' shapes."""
    if x.dim() != 4:
        raise KernelRefused(f"ssd_scan_bwd takes [B, T, H, P] x, got "
                            f"{tuple(x.shape)}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if tuple(dy.shape) != tuple(x.shape):
        raise KernelRefused(f"ssd_scan_bwd: dy {tuple(dy.shape)} does not "
                            f"match x {tuple(x.shape)}")
    if tuple(dt.shape) != (bsz, t, h):
        raise KernelRefused(f"ssd_scan_bwd: dt {tuple(dt.shape)}, expected "
                            f"{(bsz, t, h)}")
    if tuple(b.shape) != (bsz, t, n) or tuple(c.shape) != (bsz, t, n):
        raise KernelRefused(f"ssd_scan_bwd: b {tuple(b.shape)} / c "
                            f"{tuple(c.shape)}, expected {(bsz, t, n)}")
    if tuple(a_log.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise KernelRefused(f"ssd_scan_bwd: a_log {tuple(a_log.shape)} / "
                            f"d_skip {tuple(d_skip.shape)}, expected {(h,)}")
    for name, a in (("h0", h0), ("dh_t", dh_t)):
        if a is not None and tuple(a.shape) != (bsz, h, p, n):
            raise KernelRefused(f"ssd_scan_bwd: {name} {tuple(a.shape)}, "
                                f"expected {(bsz, h, p, n)}")


def contract_ssd_scan_bwd(x, dt, a_log, b, c, d_skip, h0, dy,
                          dh_t) -> None:
    """Raise unless the SSD backward takes these operands: the shapes of
    every route, the forward's rules for x, dt, b and c, h0 / dh_t float32
    contiguous, P = N = 64 (dy, h0 and dh_t are copied when
    misaligned)."""
    _bwd_shapes(x, dt, a_log, b, c, d_skip, h0, dy, dh_t)
    p, n = x.shape[3], b.shape[-1]
    if p != HEAD_DIM or n != STATE_DIM:
        raise KernelRefused(f"ssd_scan_bwd kernel takes P = {HEAD_DIM} and "
                            f"N = {STATE_DIM}, got P = {p}, N = {n}")
    _rows(x, "x", (p, 1))
    _rows(dt, "dt", (1,))
    _rows(b, "b", (1,))
    _rows(c, "c", (1,))
    for name, a in (("x", x), ("b", b), ("c", c)):
        tma_strides(name, a.shape, a.stride(), a.element_size(), addr(a))
    for name, a in (("h0", h0), ("dh_t", dh_t)):
        if a is not None:
            require(a, name, (torch.float32,), 4)
