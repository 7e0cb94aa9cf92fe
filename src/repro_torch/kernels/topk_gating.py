"""Router gating and GShard priority positions: the wrappers of
``csrc/topk_gating.cu``.

``topk_gating_fused`` counterparts the reference's fused router kernel
(router matmul + softmax + top-k, logits rounded to x's type) and
``topk_positions`` its choice-major priority-rank kernel.  A CPU tensor
takes the plain version in ``kernels.ref``; a CUDA tensor launches the
kernel (bf16 x and router only) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, LaunchCounter, check, lib,
                                        on_cpu, ptr, require, stream)

GATING = LaunchCounter("topk_gating_fused")
POSITIONS = LaunchCounter("topk_positions")

MAX_EXPERTS = 32          # experts one gating warp holds in registers
MAX_K = 4
MAX_POS_EXPERTS = 256     # per-warp count table of the positions kernel


def topk_gating_fused(x, k: int, *, router):
    """x [T, D], router [D, E] -> (idx [T,k] i32, w [T,k] f32 renormalized,
    probs [T,E] f32): the router matmul folded into the softmax + top-k
    (fp32 sums, logits rounded to x's type before the softmax).  The
    reference's logits-only form has no caller on the port's path."""
    if on_cpu(x, router):
        return ref.ref_topk_gating(x @ router, k)
    require(x, "x", BF16, 2)
    require(router, "router", BF16, 2)
    t, d = x.shape
    if router.shape[0] != d:
        raise ValueError(f"router {tuple(router.shape)} does not match "
                         f"x {tuple(x.shape)}")
    e = router.shape[1]
    if not (1 <= e <= MAX_EXPERTS and 1 <= k <= min(MAX_K, e)):
        raise ValueError(f"gating kernel takes 1 <= k <= {MAX_K}, k <= E "
                         f"<= {MAX_EXPERTS}; got k={k}, E={e}")
    idx = torch.empty((t, k), dtype=torch.int32, device=x.device)
    w = torch.empty((t, k), dtype=torch.float32, device=x.device)
    probs = torch.empty((t, e), dtype=torch.float32, device=x.device)
    status = lib("topk_gating").topk_gating(
        ptr(x), ptr(router), t, d, e, k, ptr(idx), ptr(w), ptr(probs),
        stream(x))
    check(status, "topk_gating_fused")
    GATING.inc()
    return idx, w, probs


def topk_positions(expert_idx, n_experts: int):
    """GShard priority positions: expert_idx [T, k] int32 (-1 masked) ->
    [T, k] int32 choice-major rank of each (token, choice) within its
    expert; masked entries rank 0 and advance nothing."""
    if on_cpu(expert_idx):
        return ref.ref_topk_positions(expert_idx, n_experts)
    require(expert_idx, "expert_idx", (torch.int32,), 2)
    if not 1 <= n_experts <= MAX_POS_EXPERTS:
        raise ValueError(f"positions kernel takes 1 <= E <= "
                         f"{MAX_POS_EXPERTS}, got {n_experts}")
    t, k = expert_idx.shape
    pos = torch.empty((t, k), dtype=torch.int32, device=expert_idx.device)
    status = lib("topk_gating").topk_positions(
        ptr(expert_idx), t, k, int(n_experts), ptr(pos), stream(expert_idx))
    check(status, "topk_positions")
    POSITIONS.inc()
    return pos
