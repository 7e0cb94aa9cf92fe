"""AdamW with a cosine LR schedule and global-norm clipping, on parameter
trees (NamedTuples of tensors), with the reference's fp32 arithmetic
(``src/repro/optim/adamw.py``).

The update is functional, not in place: ``adamw_update`` returns new
params and moments and leaves its inputs untouched, so the trainer's
non-finite guard can drop a step by keeping the old ones (the transient
costs one more copy of params, m and v).  The step counter lives on the
params' device, and nothing here reads a value back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    dt = DTYPES[cfg.state_dtype]
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def cosine_schedule(step, cfg: AdamWConfig):
    """Linear warmup then cosine decay to 0; ``step`` an int tensor ->
    float32 tensor."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """Scale ``grads`` to global norm <= ``max_norm``.  ``gn``, when given,
    is the norm to use (a sharded model's, over every rank's leaves)."""
    if gn is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig, *,
                 grad_norm=None):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).
    ``grad_norm`` is the global norm where ``grads`` are a shard."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=step.device), step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=step.device), step.float())

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    triples = []
    tree_map(lambda *a: triples.append(upd(*a)), params, grads, state.m,
             state.v)
    new_p, new_m, new_v = (tree_unflatten_like(params, [t[i] for t in triples])
                           for i in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gn, "lr": lr}
