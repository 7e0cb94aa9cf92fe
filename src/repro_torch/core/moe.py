"""The MoE layer on one rank: gating -> dispatch -> grouped expert FFN ->
combine (paper Fig. 1), in PyTorch.

This slice runs expert parallelism of 1: the all-to-all exchanges of the
reference's ``shard_map`` body are the identity and the Lina micro-op
pipeline (``core/microop``) is not ported yet, so ``moe_layer`` is the
reference's ``lina=False`` layer.  It is differentiable on both routes:
the kernel route's ops are ``torch.autograd.Function``s whose backward
launches kernels too (``kernels.ops``), so ``loss.backward()`` reaches the
router and the expert weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as D
from repro_torch.core.gating import capacity, router_top_k_gating
from repro_torch.kernels.ops import grouped_ffn_op, resolve_backend
from repro_torch.kernels.ref import gelu


class MoEParams(NamedTuple):
    router: torch.Tensor            # [d, E]
    wi: torch.Tensor                # [E, d, f]   (gate proj for swiglu)
    wu: Optional[torch.Tensor]      # [E, d, f]   (up proj; None for gelu)
    wo: torch.Tensor                # [E, f, d]


class MoEOutput(NamedTuple):
    y: torch.Tensor                 # [B, S, d]
    aux_loss: torch.Tensor          # scalar
    expert_idx: torch.Tensor        # [T, k] — for popularity profiling
    router_probs: torch.Tensor      # [T, E]


def expert_ffn(wi, wu, wo, x, ffn_type: str = "swiglu",
               compute_backend: str = "xla"):
    """x: [E_rows, n, d] with per-row expert weights [E_rows, d, f].
    ``"pallas"`` runs the grouped-FFN kernel route; ``"xla"`` the einsum
    formulation it is held against."""
    if compute_backend == "pallas":
        return grouped_ffn_op(x, wi, wu, wo, ffn_type)
    h = torch.einsum("end,edf->enf", x, wi)
    if ffn_type == "swiglu":
        h = F.silu(h) * torch.einsum("end,edf->enf", x, wu)
    else:
        h = gelu(h)
    return torch.einsum("enf,efd->end", h, wo)


def moe_layer(x, params: MoEParams, cfg: MoEConfig, *,
              ffn_type: str = "swiglu", dispatch_backend: str = "scatter",
              top_k: int | None = None) -> MoEOutput:
    """x: [B, S, d] on one rank -> MoEOutput."""
    b, s, d_model = x.shape
    x2 = x.reshape(b * s, d_model)
    e = cfg.n_experts
    k = top_k or cfg.top_k
    cap = capacity(b * s, e, k, cfg.capacity_factor)
    backend = resolve_backend(cfg.compute_backend)
    g = router_top_k_gating(x2, params.router, k, cap, cfg.aux_loss_weight,
                            compute_backend=backend)
    disp, comb = D.get_backend(dispatch_backend)
    buf = disp(x2, g, e, cap)                                   # [E, C, d]
    out_buf = expert_ffn(params.wi, params.wu, params.wo, buf, ffn_type,
                         backend)
    y = comb(out_buf, g, e, cap)
    return MoEOutput(y.reshape(b, s, d_model), g.aux_loss, g.expert_idx,
                     g.router_probs)
