"""Grouped expert FFN and grouped GEMM: the wrappers of ``csrc/moe_ffn.cu``.

``grouped_ffn``: per group g, act(x[g] @ wi[g]) @ wo[g] with gelu (tanh
form), or silu(x[g] @ wi[g]) * (x[g] @ wu[g]) for swiglu; fp32 sums, h
rounded to x's type before the second product.  bf16 only on the card.

``grouped_matmul``: a [E, M, K] @ b [E, K, N] -> [E, M, N] fp32, the dgrad /
wgrad GEMM of the FFN backward; each operand bf16 or fp32, row-major or the
transpose view of a row-major array (read in place), any M, N, K.  Two bf16
operands multiply exactly on bf16 tensor cores; any fp32 operand makes the
product TF32 (10-bit mantissa operands, fp32 sums).

A CPU tensor takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

GROUPED_FFN = LaunchCounter("grouped_ffn")
GROUPED_MATMUL = LaunchCounter("grouped_matmul")

TILE = 64   # D and F must be multiples of the kernel's column tile
ACT = {"gelu": 1, "swiglu": 2}


def grouped_ffn(x, wi, wu, wo, *, ffn_type: str = "swiglu"):
    """x: [G, T, D]; wi/wu: [G, D, F]; wo: [G, F, D] -> [G, T, D] x.dtype.
    ``wu`` may be None for gelu FFNs."""
    if ffn_type == "swiglu" and wu is None:
        raise ValueError("swiglu FFN requires the up projection wu")
    if on_cpu(x, wi, wu, wo):
        return ref.ref_grouped_ffn(x, wi, wu, wo, ffn_type)
    if ffn_type not in ACT:
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    require(x, "x", BF16, 3)
    g, t, d = x.shape
    f = wi.shape[-1]
    for name, a, shape in (("wi", wi, (g, d, f)), ("wo", wo, (g, f, d)),
                           ("wu", wu, (g, d, f))):
        if a is None:
            continue
        require(a, name, BF16, 3)
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(a.shape)}")
    if d % TILE or f % TILE:
        raise ValueError(f"grouped_ffn kernel takes D and F in multiples of "
                         f"{TILE}, got D={d}, F={f}")
    h = torch.empty((g, t, f), dtype=x.dtype, device=x.device)
    out = torch.empty((g, t, d), dtype=x.dtype, device=x.device)
    status = lib("moe_ffn").grouped_ffn(
        ptr(x), ptr(wi), ptr(wu if ffn_type == "swiglu" else None), ptr(wo),
        ptr(h), ptr(out), g, t, d, f, ACT[ffn_type], stream(x))
    check(status, "grouped_ffn")
    GROUPED_FFN.inc()
    return out


MM_TYPES = (torch.bfloat16, torch.float32)


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
    out = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    status = lib("moe_ffn").grouped_matmul(
        ptr(a), ptr(b), ptr(out), e, m, n, k, int(a.dtype == torch.bfloat16),
        int(b.dtype == torch.bfloat16), a_t, b_t, stream(a))
    check(status, "grouped_matmul")
    GROUPED_MATMUL.inc()
    return out
