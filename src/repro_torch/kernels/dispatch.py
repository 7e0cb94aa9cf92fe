"""Slot dispatch, gate-weighted combine and weighted replica routing: the
wrappers of ``csrc/dispatch.cu``, plus ``invert_slots``.

The caller inverts the metadata-sized (token -> slot row) map into a
(slot row -> token) index with ``invert_slots`` (plain torch: a scatter of
ids into a scratch row, no feature data), then:

  * ``dispatch_rows``  — out[r] = scale[r] * x[src[r]] (0 for src = -1);
  * ``combine_rows``   — y[t] = sum_k w[t,k] * buf[rows[t,k]] in fp32;
  * ``weighted_route`` — (expert, priority position) -> flat replica row by
    bin partition of the expert's cumulative integer weights (Lina §5/§6.2
    weighted zero-migration split).

A CPU tensor takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel (bf16 feature rows only) or raises.  Empty slots / dropped choices are -1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

DISPATCH = LaunchCounter("dispatch_rows")
COMBINE = LaunchCounter("combine_rows")
ROUTE = LaunchCounter("weighted_route")


def invert_slots(rows, n_rows: int):
    """[T, k] flat destination row per (token, choice), -1 for dropped ->
    ([n_rows] source token id, [n_rows] source choice id), -1 for empty.

    Gating guarantees destination rows are unique, so a plain scatter is
    exact; dropped choices land in a scratch row that is cut off."""
    t, k = rows.shape
    flat = rows.reshape(-1).long()
    choice = torch.arange(t * k, dtype=torch.int32, device=rows.device)
    tgt = torch.where((flat < 0) | (flat >= n_rows),
                      torch.full_like(flat, n_rows), flat)
    src = torch.full((n_rows + 1,), -1, dtype=torch.int32, device=rows.device)
    src = src.scatter(0, tgt, choice)[:-1]
    neg = torch.full_like(src, -1)
    return (torch.where(src >= 0, src // k, neg),
            torch.where(src >= 0, src % k, neg))


def dispatch_rows(x, src_tok, scale=None):
    """x: [T, d]; src_tok: [R] int32 source token per output row (-1 empty);
    scale: optional [R] f32 per-row weight (default 1).  -> [R, d] x.dtype."""
    if on_cpu(x, src_tok, scale):
        return ref.ref_dispatch_rows(x, src_tok, scale)
    require(x, "x", BF16, 2)
    require(src_tok, "src_tok", (torch.int32,), 1)
    if scale is not None:
        require(scale, "scale", (torch.float32,), 1)
        if scale.shape != src_tok.shape:
            raise ValueError("scale must match src_tok")
    t, d = x.shape
    r = src_tok.shape[0]
    out = torch.empty((r, d), dtype=x.dtype, device=x.device)
    status = lib("dispatch").dispatch_rows(
        ptr(x), ptr(src_tok), ptr(scale), t, r, d, ptr(out), stream(x))
    check(status, "dispatch_rows")
    DISPATCH.inc()
    return out


def combine_rows(buf, rows, weights):
    """buf: [R, d] slot rows; rows: [T, k] int32 flat slot per (token,
    choice), -1 dropped; weights: [T, k] f32 gate weights.  -> [T, d]
    buf.dtype."""
    if on_cpu(buf, rows, weights):
        return ref.ref_combine_rows(buf, rows, weights)
    require(buf, "buf", BF16, 2)
    require(rows, "rows", (torch.int32,), 2)
    require(weights, "weights", (torch.float32,), 2)
    if weights.shape != rows.shape:
        raise ValueError("weights must match rows")
    r, d = buf.shape
    t, k = rows.shape
    out = torch.empty((t, d), dtype=buf.dtype, device=buf.device)
    status = lib("dispatch").combine_rows(
        ptr(buf), ptr(rows), ptr(weights), r, t, k, d, ptr(out),
        stream(buf))
    check(status, "combine_rows")
    COMBINE.inc()
    return out


def weighted_route(expert_idx, position, cum_weights, slot_of,
                   slot_cap: int):
    """expert_idx: [T, k] int32 chosen expert (-1 dropped); position: [T, k]
    int32 GShard priority rank within the expert; cum_weights: [E, R] int32
    inclusive cumsum of the per-replica integer routing weights; slot_of:
    [E, R] int32 global slot per replica (-1 pads).  -> [T, k] int32 flat
    destination row (slot * slot_cap + offset), -1 for dropped."""
    if on_cpu(expert_idx, position, cum_weights, slot_of):
        return ref.ref_weighted_route(expert_idx, position, cum_weights,
                                      slot_of, slot_cap)
    for name, a in (("expert_idx", expert_idx), ("position", position),
                    ("cum_weights", cum_weights), ("slot_of", slot_of)):
        require(a, name, (torch.int32,), 2)
    if position.shape != expert_idx.shape or \
            slot_of.shape != cum_weights.shape:
        raise ValueError("weighted_route: mismatched shapes")
    t, k = expert_idx.shape
    e, rw = cum_weights.shape
    out = torch.empty((t, k), dtype=torch.int32, device=expert_idx.device)
    status = lib("dispatch").weighted_route(
        ptr(expert_idx), ptr(position), ptr(cum_weights), ptr(slot_of),
        t * k, e, rw, int(slot_cap), ptr(out), stream(expert_idx))
    check(status, "weighted_route")
    ROUTE.inc()
    return out
