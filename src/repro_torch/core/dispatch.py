"""Token dispatch/combine into per-expert capacity buffers, in PyTorch.

Two backends with identical semantics:
  * ``scatter`` — index-based scatter/gather (the training forward's
    default, which the profiling pass uses);
  * ``pallas``  — the kernel route: a metadata-sized int32 slot inversion
    (``kernels.dispatch.invert_slots``) plus the ``dispatch_rows`` /
    ``combine_rows`` kernels.

Both produce ``[E, C, d]`` dispatch buffers.
"""
from __future__ import annotations

import torch

from repro_torch.core.gating import GatingResult
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.dispatch import invert_slots


def dispatch_scatter(x, g: GatingResult, n_experts: int, cap: int):
    """x: [T, d] -> buffers [E, C, d] via scatter; dropped tokens land in a
    scratch row that is cut off."""
    t, d = x.shape
    k = g.expert_idx.shape[1]
    flat_slot = g.expert_idx.long() * cap + g.position.long()      # [T, k]
    flat_slot = torch.where(g.dropped, torch.full_like(flat_slot,
                                                       n_experts * cap),
                            flat_slot)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    src = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = buf.index_copy(0, flat_slot.reshape(-1), src)
    return buf[:-1].reshape(n_experts, cap, d)


def combine_scatter(buf, g: GatingResult, n_experts: int, cap: int):
    flat = buf.reshape(n_experts * cap, -1)
    slot = g.expert_idx.long() * cap + g.position.long()            # [T, k]
    slot = torch.clamp(slot, 0, n_experts * cap - 1)
    gathered = flat[slot]                                           # [T, k, d]
    w = torch.where(g.dropped, torch.zeros_like(g.gate_weights),
                    g.gate_weights)[..., None]
    # combine in the buffer dtype, as the reference does
    return torch.sum(gathered * w.to(buf.dtype), dim=1)


def _flat_rows(g: GatingResult, cap: int):
    """[T, k] flat capacity-buffer row per (token, choice); -1 = dropped."""
    rows = g.expert_idx * cap + g.position
    return torch.where(g.dropped, torch.full_like(rows, -1), rows)


def dispatch_pallas(x, g: GatingResult, n_experts: int, cap: int):
    """x: [T, d] -> buffers [E, C, d] via the dispatch kernel."""
    rows = _flat_rows(g, cap)
    src_tok, _ = invert_slots(rows, n_experts * cap)
    return kernel_ops.dispatch_op(x, src_tok).reshape(n_experts, cap,
                                                      x.shape[-1])


def combine_pallas(buf, g: GatingResult, n_experts: int, cap: int):
    rows = _flat_rows(g, cap)
    w = torch.where(g.dropped, torch.zeros_like(g.gate_weights),
                    g.gate_weights)
    return kernel_ops.combine_op(buf.reshape(n_experts * cap, -1), rows, w)


BACKENDS = {
    "scatter": (dispatch_scatter, combine_scatter),
    "pallas": (dispatch_pallas, combine_pallas),
}


def get_backend(name: str):
    return BACKENDS[name]
