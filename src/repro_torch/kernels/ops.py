"""Kernel entry points the port's models call, and the backend switch.

``MoEConfig.compute_backend`` maps onto the port as follows:

  ============  ==========================================================
  ``"auto"``    the kernel route: each op calls its kernel wrapper, which
  ``"pallas"``  launches the Hopper kernel for a CUDA tensor and runs its
                plain PyTorch version for a CPU tensor
  ``"xla"``     the plain tensor path (einsum / scatter code in ``core``)
  ============  ==========================================================

So "auto" and "pallas" name the same route here: the device of the tensor
decides, never whether a card is present, and a tensor on any other device
raises (``kernels._build.on_cpu``).  On a CUDA tensor the kernels take
bf16 activations and weights, the compute type of every paper model; a
float32 CUDA tensor raises.  The serve path is forward-only, so no
op carries a backward yet.  The ops make their inputs contiguous and of the
index type the kernels take.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                          weighted_route)
from repro_torch.kernels.moe_ffn import grouped_ffn
from repro_torch.kernels.topk_gating import topk_gating_fused, topk_positions


def resolve_backend(name: str | None) -> str:
    """``MoEConfig.compute_backend`` -> "pallas" (kernel route) or "xla"
    (plain tensor path)."""
    if name in (None, "", "auto", "pallas"):
        return "pallas"
    if name != "xla":
        raise ValueError(f"unknown compute backend {name!r}")
    return name


def grouped_ffn_op(x, wi, wu, wo, ffn_type: str = "swiglu"):
    wu = wu.contiguous() if wu is not None else None
    return grouped_ffn(x.contiguous(), wi.contiguous(), wu, wo.contiguous(),
                       ffn_type=ffn_type)


def topk_gating_op(x, router, k: int):
    """Fused gating network: x [T, D] @ router [D, E] folded into the
    softmax + top-k kernel -> (idx [T,k] i32, w [T,k] f32, probs [T,E] f32).
    """
    return topk_gating_fused(x.contiguous(), k, router=router.contiguous())


def topk_positions_op(expert_idx, n_experts: int):
    """expert_idx [T, k] i32 -> [T, k] i32 choice-major priority rank."""
    return topk_positions(expert_idx.int().contiguous(), n_experts)


def weighted_route_op(expert_idx, position, cum_weights, slot_of,
                      slot_cap: int):
    """(expert, priority position) -> flat replica row, -1 dropped."""
    return weighted_route(expert_idx.int().contiguous(),
                          position.int().contiguous(),
                          cum_weights.int().contiguous(),
                          slot_of.int().contiguous(), slot_cap)


def dispatch_op(x, src_tok):
    """x [T, d], src_tok [R] i32 -> [R, d] slot rows (0 where src = -1)."""
    return dispatch_rows(x.contiguous(), src_tok.int().contiguous())


def combine_op(buf, rows, weights):
    """buf [R, d], rows [T, k] i32, weights [T, k] -> [T, d] in buf.dtype."""
    return combine_rows(buf.contiguous(), rows.int().contiguous(),
                        weights.float().contiguous())

