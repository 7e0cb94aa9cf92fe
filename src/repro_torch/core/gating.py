"""Top-k gating with capacity and the Switch/GShard auxiliary load-balancing
loss (paper §2.1), in PyTorch.

The gating network is one matrix; tokens go to their top-k experts subject
to a per-expert capacity, so every buffer shape is static.  Both routes are
differentiable in x and the router: the plain route by autograd through
the gather of the top-k probabilities, the kernel route through the gating
op's backward (``kernels.ops``); the aux loss through the mean probs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import first_max_topk


class GatingResult(NamedTuple):
    expert_idx: torch.Tensor   # [T, k] int32 — chosen expert per token/slot
    gate_weights: torch.Tensor  # [T, k] — combine weights (softmax renormed)
    position: torch.Tensor     # [T, k] int32 — position within expert buffer
    dropped: torch.Tensor      # [T, k] bool — True if over capacity
    aux_loss: torch.Tensor     # scalar — load-balancing loss
    router_probs: torch.Tensor  # [T, E] — full softmax (popularity profiling)


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Per-expert buffer capacity, rounded up to a multiple of 8."""
    c = int(n_tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)


def gating_from_topk(expert_idx, gate_w, probs, cap: int,
                     aux_loss_weight: float = 0.01,
                     position=None) -> GatingResult:
    """Shared capacity/position/aux epilogue: raw top-k picks (idx [T,k],
    renormalized weights [T,k], full probs [T,E]) -> complete dispatch
    metadata.  ``position`` may come precomputed (the positions kernel);
    when None the [T, k, E] one-hot cumsum runs here."""
    n_tokens, n_experts = probs.shape
    top_k = expert_idx.shape[1]
    ar = torch.arange(n_experts, device=probs.device)

    # aux loss (Switch eq.4): E * sum_e f_e * p_e, f_e from top-1 assignment
    top1 = expert_idx[:, 0].long()
    f_e = (top1[:, None] == ar).float().mean(0)
    p_e = probs.mean(0)
    aux = aux_loss_weight * n_experts * torch.sum(f_e * p_e)

    if position is None:
        # all tokens' 1st choice before any 2nd choice (GShard priority)
        onehot = (expert_idx.long()[..., None] == ar).to(torch.int32)
        flat = onehot.transpose(0, 1).reshape(top_k * n_tokens, n_experts)
        pos_flat = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
        pos = pos_flat.reshape(top_k, n_tokens, n_experts).transpose(0, 1)
        position = torch.sum(pos * onehot, dim=-1, dtype=torch.int32)
    dropped = position >= cap
    gate_w = torch.where(dropped, torch.zeros_like(gate_w), gate_w)
    return GatingResult(expert_idx.to(torch.int32), gate_w,
                        position.to(torch.int32), dropped, aux, probs)


def top_k_gating(logits, top_k: int, cap: int,
                 aux_loss_weight: float = 0.01) -> GatingResult:
    """logits: [T, E] -> dispatch metadata (plain tensor path)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_w, expert_idx = first_max_topk(probs, top_k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gating_from_topk(expert_idx, gate_w, probs, cap, aux_loss_weight)


def router_top_k_gating(x, router, top_k: int, cap: int,
                        aux_loss_weight: float = 0.01, *,
                        compute_backend: str = "xla") -> GatingResult:
    """The gating network: ``x @ router`` + softmax + top-k.  On the kernel
    route ("pallas") the router matmul is folded into the gating kernel and
    the priority positions come from the positions kernel; the epilogue is
    shared, so both routes give identical GatingResults."""
    if compute_backend != "pallas":
        return top_k_gating(x @ router, top_k, cap, aux_loss_weight)
    idx, gate_w, probs = kernel_ops.topk_gating_op(x, router, top_k)
    position = kernel_ops.topk_positions_op(idx, probs.shape[-1])
    return gating_from_topk(idx, gate_w, probs, cap, aux_loss_weight,
                            position=position)
