"""Grouped expert FFN and grouped GEMM: the wrappers of ``csrc/moe_ffn.cu``
and ``csrc/grouped_matmul.cu``.

``grouped_ffn``: per group g, act(x[g] @ wi[g]) @ wo[g] with gelu (tanh
form), or silu(x[g] @ wi[g]) * (x[g] @ wu[g]) for swiglu; fp32 sums, h
rounded to x's type before the second product.  bf16 only on the card.
Two options: ``group_expert`` makes group g read expert group_expert[g] of
unexpanded [E, ...] weights in place (-1: an empty group, zeros), and
``group_rows`` zeroes every row r >= group_rows[g] (the kernel skips the
tiles wholly past it).

``grouped_matmul``: a [E, M, K] @ b [E, K, N] -> [E, M, N] fp32, the dgrad /
wgrad GEMM of the FFN backward; each operand bf16 or fp32, row-major or the
transpose view of a row-major array (read in place), any M, N, K.  Two bf16
operands multiply exactly on bf16 tensor cores; any fp32 operand makes the
product TF32 (fp32 operands rounded to nearest to a 10-bit mantissa, bf16
ones exact, fp32 sums).  On the card the kernel loads tiles with TMA, which
narrows the contract: each operand's contiguous dimension times its element
size is a multiple of 16 bytes (8 bf16 or 4 fp32 values) and its base is
16-byte aligned (``tma_operand_rule``); ``mm_plan`` picks the kernel.

A CPU tensor takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

GROUPED_FFN = LaunchCounter("grouped_ffn")
GROUPED_MATMUL = LaunchCounter("grouped_matmul")

TILE = 64   # D and F must be multiples of the kernel's column tile
ACT = {"gelu": 1, "swiglu": 2}


def grouped_ffn(x, wi, wu, wo, *, ffn_type: str = "swiglu",
                group_expert=None, group_rows=None):
    """x: [G, T, D]; wi/wu: [G, D, F]; wo: [G, F, D] -> [G, T, D] x.dtype.
    ``wu`` may be None for gelu FFNs.

    ``group_expert`` (int32 [G], values in [-1, E)): the weights are the
    unexpanded [E, D, F] / [E, F, D] parameters and group g reads expert
    group_expert[g] in place; a group of -1 gives zeros.  ``group_rows``
    (int32 [G]): out[g, r] = 0 for r >= group_rows[g].  Both live on x's
    device and are read there (no host sync)."""
    if ffn_type == "swiglu" and wu is None:
        raise ValueError("swiglu FFN requires the up projection wu")
    if on_cpu(x, wi, wu, wo, group_expert, group_rows):
        return ref.ref_grouped_ffn(x, wi, wu, wo, ffn_type, group_expert,
                                   group_rows)
    if ffn_type not in ACT:
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    require(x, "x", BF16, 3)
    g, t, d = x.shape
    e, f = wi.shape[0], wi.shape[-1]
    if group_expert is None and e != g:
        raise ValueError(f"grouped_ffn: {e} weight groups for {g} groups of "
                         f"x (pass group_expert to index them)")
    for name, a, shape in (("wi", wi, (e, d, f)), ("wo", wo, (e, f, d)),
                           ("wu", wu, (e, d, f))):
        if a is None:
            continue
        require(a, name, BF16, 3)
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(a.shape)}")
    for name, a in (("group_expert", group_expert),
                    ("group_rows", group_rows)):
        if a is not None:
            require(a, name, (torch.int32,), 1)
            if a.shape[0] != g:
                raise ValueError(f"{name}: expected [{g}], got "
                                 f"{tuple(a.shape)}")
    if d % TILE or f % TILE:
        raise ValueError(f"grouped_ffn kernel takes D and F in multiples of "
                         f"{TILE}, got D={d}, F={f}")
    for name, a in (("x", x), ("wi", wi), ("wu", wu), ("wo", wo)):
        if a is not None:
            tma_operand_rule(f"grouped_ffn {name}", a.shape, False,
                             a.element_size(), a.data_ptr())
    h = torch.empty((g, t, f), dtype=x.dtype, device=x.device)
    out = torch.empty((g, t, d), dtype=x.dtype, device=x.device)
    status = lib("moe_ffn").grouped_ffn(
        ptr(x), ptr(wi), ptr(wu if ffn_type == "swiglu" else None), ptr(wo),
        ptr(group_expert), ptr(group_rows), ptr(h), ptr(out), g, t, d, f, e,
        ACT[ffn_type], stream(x))
    check(status, "grouped_ffn")
    GROUPED_FFN.inc()
    return out


MM_TYPES = (torch.bfloat16, torch.float32)
# operand kinds of csrc/grouped_matmul.cu: bit 0 bf16 (else fp32), bit 1 the
# operand is stored M- or N-major (its M or N index contiguous), else K-major
KIND_BF16, KIND_MN_MAJOR = 1, 2


class MMPlan(NamedTuple):
    kernel: str   # "bf16": bf16 wgmma on the tiles as they land; "tf32":
    a_kind: int   # tf32 wgmma behind the transform to K-major fp32
    b_kind: int


def mm_plan(a_bf16: bool, b_bf16: bool, a_t: bool, b_t: bool) -> MMPlan:
    """The kernel and the operand kinds for one dtype x layout mix.  ``a_t``:
    a is the transpose view of a row-major [E, K, M] array (M-major), else
    row-major [E, M, K] (K-major); ``b_t``: b is the transpose view of a
    row-major [E, N, K] array (K-major), else row-major [E, K, N]
    (N-major)."""
    a_kind = int(a_bf16) | (KIND_MN_MAJOR if a_t else 0)
    b_kind = int(b_bf16) | (0 if b_t else KIND_MN_MAJOR)
    return MMPlan("bf16" if a_bf16 and b_bf16 else "tf32", a_kind, b_kind)


def tma_operand_rule(name: str, shape, transposed: bool, itemsize: int,
                     data_ptr: int = 0) -> None:
    """Raise ValueError unless the TMA can load the operand: a [E, R, C]
    operand stored row-major (or, ``transposed``, as [E, C, R]) needs its
    contiguous dimension times ``itemsize`` to be a multiple of 16 bytes
    (every global stride but the innermost) and its base 16-byte aligned."""
    inner = shape[1] if transposed else shape[2]
    if (inner * itemsize) % 16 or data_ptr % 16:
        raise ValueError(
            f"{name}: the TMA needs the contiguous dimension "
            f"({inner} values of {itemsize} bytes) to be a multiple of 16 "
            f"bytes and the base address (offset {data_ptr % 16}) 16-byte "
            f"aligned")


def _layout(t):
    """(tensor, transposed): ``t`` itself when it is row-major, or when it
    is the transpose view of a row-major [E, cols, rows] array (flag 1, no
    copy); any other layout is copied into row-major."""
    if t.is_contiguous():
        return t, 0
    if t.transpose(1, 2).is_contiguous():
        return t, 1
    return t.contiguous(), 0


def grouped_matmul(a, b):
    """a: [E, M, K]; b: [E, K, N], each bf16 or float32 -> [E, M, N] fp32."""
    if on_cpu(a, b):
        return ref.ref_grouped_matmul(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in MM_TYPES:
            raise TypeError(f"grouped_matmul {name}: dtype {t.dtype} not in "
                            f"{list(MM_TYPES)}")
        if t.dim() != 3:
            raise ValueError(f"grouped_matmul {name}: expected 3 dims, got "
                             f"{tuple(t.shape)}")
    e, m, k = a.shape
    if b.shape[0] != e or b.shape[1] != k:
        raise ValueError(f"grouped_matmul: a {tuple(a.shape)} does not "
                         f"match b {tuple(b.shape)}")
    n = b.shape[2]
    a, a_t = _layout(a)
    b, b_t = _layout(b)
    for name, t, tr in (("a", a, a_t), ("b", b, b_t)):
        tma_operand_rule(f"grouped_matmul {name}", t.shape, tr,
                         t.element_size(), t.data_ptr())
    out = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    plan = mm_plan(a.dtype == torch.bfloat16, b.dtype == torch.bfloat16,
                   bool(a_t), bool(b_t))
    status = lib("grouped_matmul").grouped_matmul(
        ptr(a), ptr(b), ptr(out), e, m, n, k, plan.a_kind, plan.b_kind,
        stream(a))
    check(status, "grouped_matmul")
    GROUPED_MATMUL.inc()
    return out
