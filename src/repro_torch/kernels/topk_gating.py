"""Router gating and GShard priority positions: the wrappers of
``csrc/topk_gating.cu``.

``topk_gating_fused`` counterparts the reference's fused router kernel
(router matmul + softmax + top-k, logits rounded to x's type) and
``topk_positions`` its choice-major priority-rank kernel.  A CPU tensor
takes the plain version in ``kernels.ref``; a CUDA tensor launches the
kernel (bf16 x and router only) or raises.  The gating kernel loads x (and
the router, where E is a multiple of 8) by TMA, so x's rows must be a
positive multiple of 16 bytes (D % 8 == 0) and both bases 16-byte aligned.
``contract_topk_gating`` / ``contract_topk_positions`` hold every refusal
of the two kernels; the card's route and the meta route (outputs
allocated on ``meta``, nothing launched or counted) both run them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (BF16, KernelRefused, LaunchCounter,
                                        addr, check, lib, on_cpu, ptr,
                                        require, stream)
from repro_torch.kernels.moe_ffn import tma_operand_rule

GATING = LaunchCounter("topk_gating_fused")
POSITIONS = LaunchCounter("topk_positions")

MAX_EXPERTS = 256         # router columns one wgmma product holds
MAX_K = 4                 # choices: one a thread of the accumulator's quad
MAX_POS_EXPERTS = 256     # per-warp count table of the positions kernel
MAX_POS_ENTRIES = 1 << 30  # T * k: the kernel's flat offsets are int32


def contract_topk_gating(x, router, k: int) -> None:
    """Raise unless the gating kernel takes x [T, D] and router [D, E]
    (bf16, contiguous, 1 <= E <= 256, 1 <= k <= min(4, E), D a multiple of
    8 and x 16-byte aligned; the router too where E % 8 == 0).  Reads only
    shapes, dtypes, strides and base addresses (``_build.addr``)."""
    require(x, "x", BF16, 2)
    require(router, "router", BF16, 2)
    t, d = x.shape
    if router.shape[0] != d:
        raise KernelRefused(f"router {tuple(router.shape)} does not match "
                            f"x {tuple(x.shape)}")
    e = router.shape[1]
    if not (1 <= e <= MAX_EXPERTS and 1 <= k <= min(MAX_K, e)):
        raise KernelRefused(f"gating kernel takes 1 <= k <= {MAX_K}, k <= E "
                            f"<= {MAX_EXPERTS}; got k={k}, E={e}")
    if d == 0:
        raise KernelRefused("gating kernel takes D >= 8, got 0")
    tma_operand_rule("topk_gating_fused x", (1, t, d), False, 2, addr(x))
    if e % 8 == 0:
        tma_operand_rule("topk_gating_fused router", (1, d, e), False, 2,
                         addr(router))


def topk_gating_fused(x, k: int, *, router):
    """x [T, D], router [D, E] -> (idx [T,k] i32, w [T,k] f32 renormalized,
    probs [T,E] f32): the router matmul folded into the softmax + top-k
    (fp32 sums, logits rounded to x's type before the softmax).  The
    reference's logits-only form has no caller on the port's path."""
    if on_cpu(x, router):
        return ref.ref_topk_gating(x @ router, k)
    contract_topk_gating(x, router, k)
    (t, d), e = x.shape, router.shape[1]
    idx = torch.empty((t, k), dtype=torch.int32, device=x.device)
    w = torch.empty((t, k), dtype=torch.float32, device=x.device)
    probs = torch.empty((t, e), dtype=torch.float32, device=x.device)
    if x.is_meta:
        return idx, w, probs
    status = lib("topk_gating").topk_gating(
        ptr(x), ptr(router), t, d, e, k, ptr(idx), ptr(w), ptr(probs),
        stream(x))
    check(status, "topk_gating_fused")
    GATING.inc()
    return idx, w, probs


def topk_positions(expert_idx, n_experts: int):
    """GShard priority positions: expert_idx [T, k] int32 (-1 masked) ->
    [T, k] int32 choice-major rank of each (token, choice) within its
    expert; masked entries and ids >= E rank 0 and advance nothing.  On the
    card: one launch, of one CTA up to 1,024 entries, else of a
    thread-block cluster that splits the T*k entries of the choice-major
    order (``positions_plan``)."""
    if on_cpu(expert_idx):
        return ref.ref_topk_positions(expert_idx, n_experts)
    contract_topk_positions(expert_idx, n_experts)
    t, k = expert_idx.shape
    pos = torch.empty((t, k), dtype=torch.int32, device=expert_idx.device)
    if expert_idx.is_meta:
        return pos
    status = lib("topk_gating").topk_positions(
        ptr(expert_idx), t, k, int(n_experts), ptr(pos), stream(expert_idx))
    check(status, "topk_positions")
    POSITIONS.inc()
    return pos


def contract_topk_positions(expert_idx, n_experts: int) -> None:
    """Raise unless the positions kernel takes expert_idx [T, k] (int32,
    contiguous, 1 <= E <= 256, T*k <= 2^30: int32 flat offsets)."""
    require(expert_idx, "expert_idx", (torch.int32,), 2)
    if not 1 <= n_experts <= MAX_POS_EXPERTS:
        raise KernelRefused(f"positions kernel takes 1 <= E <= "
                            f"{MAX_POS_EXPERTS}, got {n_experts}")
    t, k = expert_idx.shape
    if t * k > MAX_POS_ENTRIES:
        raise KernelRefused(f"positions kernel takes T*k <= "
                            f"{MAX_POS_ENTRIES}, got {t} x {k}")


POSITIONS_WALKS = ("one CTA", "one pass", "second walk")


def positions_plan(n: int) -> tuple:
    """What ``topk_positions`` launches on the card for n = T*k entries:
    (CTAs, chunks of 1,024 entries each CTA owns, walk): "one CTA" for n
    <= 1024, else a cluster whose CTAs rank their spans in "one pass" or
    count them and take a "second walk".  Needs the card (the largest
    cluster is the card's); launches nothing."""
    out = (ctypes.c_int * 3)()
    check(lib("topk_gating").topk_positions_plan(int(n), out),
          "topk_positions_plan")
    return out[0], out[1], POSITIONS_WALKS[out[2]]
