"""Gradient compression for the data-parallel reduction (the reference's
``src/repro/optim/compression.py``): a bf16 cast, and int8 with an error
feedback residual.

Consumed by ``optim.reduce`` (``ReduceConfig.compression``).  The int8
residual (``Int8State``) is carried across steps as the trainer's
``reduce_state`` and rides in checkpoints.  ``compress_int8_ef`` takes an
optional per-leaf ``scales`` list: the reduction passes the maximum of the
ranks' scales, so that every rank quantizes on one grid (the reference's
gradients are replicated, so its ranks' scales agree by construction).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def compress_bf16(tree):
    return tree_map(lambda g: g.to(torch.bfloat16), tree)


def decompress_bf16(tree, like):
    return tree_map(lambda g, p: g.to(p.dtype), tree, like)


class Int8State(NamedTuple):
    """Error-feedback residual (one per gradient leaf)."""
    residual: Any


def init_int8_state(params) -> Int8State:
    return Int8State(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def int8_scales(grads, state: Int8State) -> list:
    """Per-leaf scale max |g + residual| / 127 (floored at 1e-12 / 127),
    as 0-d float32 tensors in leaf order."""
    return [torch.clamp(torch.max(torch.abs(g.float() + r)), min=1e-12)
            / 127.0 for g, r in zip(tree_leaves(grads),
                                    tree_leaves(state.residual))]


def compress_int8_ef(grads, state: Int8State,
                     scales: Optional[list] = None):
    """Error-feedback int8: quantize (g + residual), carry the error.
    Returns ((q_int8 tree, scales list), new_state)."""
    if scales is None:
        scales = int8_scales(grads, state)
    qs, errs = [], []
    for g, r, sc in zip(tree_leaves(grads), tree_leaves(state.residual),
                        scales):
        g32 = g.float() + r
        q = torch.clamp(torch.round(g32 / sc), -127, 127).to(torch.int8)
        qs.append(q)
        errs.append(g32 - q.float() * sc)
    return ((tree_unflatten_like(grads, qs), list(scales)),
            Int8State(tree_unflatten_like(grads, errs)))


def decompress_int8(qs, scales, like=None):
    out = [q.float() * s for q, s in zip(tree_leaves(qs), scales)]
    out = tree_unflatten_like(qs, out)
    if like is not None:
        out = tree_map(lambda g, p: g.to(p.dtype), out, like)
    return out
