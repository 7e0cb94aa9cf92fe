"""The train step of the port: forward, backward and the AdamW update on
one rank (the reference's ``launch/steps.py::make_train_step`` with
``schedule=None``).

Expert parallelism is 1 here, so there is no all-to-all and no
data-parallel gradient reduction: the §4 reduction schedules
(``optim/reduce.py``), gradient compression and the ScMoE shortcut come
with ROADMAP's "expert parallelism and the §4 schedule", and asking for
them raises.  The config's ``n_microops`` / ``pipeline_ffn`` chunk the
expert-parallel all-to-all only; the single-rank MoE layer runs its
capacity buffer in one piece.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

EXPERT_PARALLELISM = ("is not ported yet: it arrives with expert "
                      "parallelism over NCCL (ROADMAP: \"expert parallelism "
                      "and the §4 schedule\")")


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, *,
                    dispatch_backend: str = "scatter",
                    microbatches: int = 1,
                    schedule: Optional[str] = None,
                    grad_compression: Optional[str] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` are the fp32 master ``LMParams``; ``batch`` holds ``tokens``
    and ``labels`` [B, S] tensors on their device.  ``microbatches > 1``
    sums the gradients of B / microbatches slices, then divides, as the
    reference's scan.  ``metrics`` holds 0-d tensors ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` (still on the device: reading one waits for
    the step)."""
    if schedule is not None:
        raise NotImplementedError(f"gradient-reduction schedule "
                                  f"{schedule!r} {EXPERT_PARALLELISM}")
    if grad_compression is not None:
        raise NotImplementedError(f"grad_compression {grad_compression!r} "
                                  f"{EXPERT_PARALLELISM}")
    if cfg.moe.enabled and cfg.moe.shortcut:
        raise NotImplementedError(f"the ScMoE shortcut {EXPERT_PARALLELISM}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)

    def grads_of(params, batch):
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        out = lm_mod.forward_train(cfg, ps, batch,
                                   dispatch_backend=dispatch_backend)
        grads = torch.autograd.grad(out.loss, tree_leaves(ps))
        return (tree_unflatten_like(params, grads), out.loss.detach(),
                out.aux_loss.detach())

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            grads, loss, aux = grads_of(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            grads = loss = aux = None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, l, a = grads_of(params, mb)
                if grads is None:
                    grads, loss, aux = g, l, a
                else:
                    grads = tree_map(torch.add, grads, g)
                    loss, aux = loss + l, aux + a
            grads = tree_map(lambda g: g / microbatches, grads)
            loss, aux = loss / microbatches, aux / microbatches
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step
