"""Grouped expert FFN: the wrapper of ``csrc/moe_ffn.cu``.

Per group g: act(x[g] @ wi[g]) @ wo[g] with gelu (tanh form), or
silu(x[g] @ wi[g]) * (x[g] @ wu[g]) for swiglu; fp32 sums, h rounded to
x's type before the second product.  A CPU tensor takes the plain version
in ``kernels.ref``; a CUDA tensor launches the kernel (bf16 only) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

GROUPED_FFN = LaunchCounter("grouped_ffn")

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
