"""The MoE transformer LM (the ``"moe"`` family: the paper's §7.1 models),
in PyTorch.

Parameters are NamedTuples of tensors in the reference's layout: every
leaf of ``LMParams.stack`` carries a leading layer-group dim G (one group =
``moe.every`` transformer blocks; ``attn``/``ln*`` add an ``every`` dim).
``forward_train`` is the training forward (loss plus per-layer top-1
expert choices, differentiable in the params) that the train step and the
profiling stage run; serving runs layer by layer in ``runtime.server``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.moe import MoEParams, moe_layer
from repro_torch.devices import resolve_device
from repro_torch.models.attention import AttnParams, KVCache, attention
from repro_torch.models.layers import dense_init, ffn_branch, rms_norm
from repro_torch.tree import tree_map

CE_CHUNK = 1024      # sequence chunk for the memory-bounded CE

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class FFNParams(NamedTuple):
    w_in: torch.Tensor                  # [d, f]
    w_up: Optional[torch.Tensor]        # [d, f] (swiglu) or None
    w_out: torch.Tensor                 # [f, d]


class GroupParams(NamedTuple):
    """Layer groups (= ``moe.every`` blocks each), stacked over groups."""
    attn: AttnParams                    # [G, every, ...]
    ln1: torch.Tensor                   # [G, every, d]
    ln2: torch.Tensor                   # [G, every, d]
    ffn: Optional[FFNParams]            # [G, n_dense, ...] or None
    moe: Optional[MoEParams]            # [G, ...]
    shared: Optional[FFNParams]         # [G, ...] shared expert or None


class LMParams(NamedTuple):
    embed: torch.Tensor                 # [V, d]
    stack: GroupParams
    final_norm: torch.Tensor            # [d]
    lm_head: Optional[torch.Tensor]     # [d, V] or None (tied)


class LMCache(NamedTuple):
    """Decode state of the transformer family (the reference's LMCache
    without the mamba / rwkv states of the other families)."""
    kv: KVCache                         # [G, every, B, S_max, KV, hd]
    pos: torch.Tensor                   # [B] next position


class ModelOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    aux_loss: torch.Tensor
    expert_choices: Optional[torch.Tensor]   # [n_moe_layers, T] top-1


def tree_idx(tree, i):
    return tree_map(lambda a: a[i], tree)


def _check_family(cfg) -> None:
    if cfg.layer_pattern or cfg.attention_free or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only the transformer family is ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator, device="cuda") -> LMParams:
    """Random weights with the reference's distributions: N(0, 1/fan_in)
    dense layers, N(0, 1/d) embeddings and router, ones for norms, on
    ``device`` (the card by default; raises without one).  ``gen`` is a
    generator on that device.  The numbers are not JAX's; tests convert
    the reference's with ``repro_torch.convert.from_reference``."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    every = cfg.moe.every if cfg.moe.enabled else 1
    g = cfg.n_layers // every
    n_dense = (every - 1) if cfg.moe.enabled else every
    f_moe = cfg.moe.d_ff or cfg.d_ff

    def dense(shape, scale_axis=-2):
        # stacked leaves: the fan-in is the second-to-last dim
        return dense_init(gen, shape, scale_axis, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ffn(lead, f):
        return FFNParams(dense((*lead, d, f)),
                         dense((*lead, d, f))
                         if cfg.ffn_type == "swiglu" else None,
                         dense((*lead, f, d)))

    embed = dense((cfg.vocab_size, d), scale_axis=-1)
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = AttnParams(
        dense((g, every, d, hq)), dense((g, every, d, hkv)),
        dense((g, every, d, hkv)), dense((g, every, hq, d)),
        zeros(g, every, hq) if cfg.qkv_bias else None,
        zeros(g, every, hkv) if cfg.qkv_bias else None,
        zeros(g, every, hkv) if cfg.qkv_bias else None,
        ones(g, every, hd) if cfg.qk_norm else None,
        ones(g, every, hd) if cfg.qk_norm else None)
    moe = None
    if cfg.moe.enabled:
        e = cfg.moe.n_experts
        moe = MoEParams(dense((g, d, e)), dense((g, e, d, f_moe)),
                        dense((g, e, d, f_moe))
                        if cfg.ffn_type == "swiglu" else None,
                        dense((g, e, f_moe, d)))
    shared = ffn((g,), f_moe) if cfg.moe.enabled and (
        cfg.moe.shared_expert or cfg.moe.shortcut) else None
    stack = GroupParams(attn, ones(g, every, d), ones(g, every, d),
                        ffn((g, n_dense), cfg.d_ff) if n_dense else None,
                        moe, shared)
    lm_head = None if cfg.tie_embeddings else dense((d, cfg.vocab_size))
    return LMParams(embed, stack, ones(d), lm_head)


def cast_for_compute(cfg, params: LMParams) -> LMParams:
    """Master params -> compute dtype; non-float leaves untouched."""
    dt = DTYPES[cfg.dtype]

    def one(p):
        return p.to(dt) if p.is_floating_point() else p
    return tree_map(one, params)


def unembed_weight(params: LMParams):
    return params.embed.T if params.lm_head is None else params.lm_head


def _ffn_apply(p: FFNParams, x, ffn_type):
    return ffn_branch(x, p.w_in, p.w_up, p.w_out, ffn_type)


def _ce_chunk(xc, w_unembed, lab, m):
    logits = (xc @ w_unembed).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum()


def chunked_ce_loss(x, w_unembed, labels, loss_mask, chunk=CE_CHUNK,
                    remat: bool = False):
    """Cross-entropy over sequence chunks without [B, S, V] logits.  With
    ``remat`` each chunk's logits are recomputed in the backward instead of
    saved, as the reference's checkpointed chunk scan."""
    b, s, d = x.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for i in range(0, s, c):
        args = (x[:, i:i + c], w_unembed, labels[:, i:i + c],
                loss_mask[:, i:i + c])
        nll = checkpoint(_ce_chunk, *args, use_reentrant=False) if remat \
            else _ce_chunk(*args)
        tot = tot + nll
        cnt = cnt + args[3].sum()
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _group_apply(cfg, gp: GroupParams, x, dispatch_backend: str):
    """One layer group (``moe.every`` blocks) on [B, S, d] ->
    (x, aux loss, top-1 expert per token or None)."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1 = None
    for j in range(every):
        h = rms_norm(x, gp.ln1[j], cfg.norm_eps)
        y, _ = attention(tree_idx(gp.attn, j), h, cfg)
        x = x + y
        h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
        if not (cfg.moe.enabled and j == every - 1):
            x = x + _ffn_apply(tree_idx(gp.ffn, j), h, cfg.ffn_type)
            continue
        out = moe_layer(h, gp.moe, cfg.moe, ffn_type=cfg.ffn_type,
                        dispatch_backend=dispatch_backend)
        moe_y = out.y
        if gp.shared is not None:
            moe_y = moe_y + _ffn_apply(gp.shared, h, cfg.ffn_type)
        x = x + moe_y
        aux = aux + out.aux_loss
        top1 = out.expert_idx[:, 0]
    return x, aux, top1


def forward_train(cfg, params: LMParams, batch: dict, *,
                  dispatch_backend: str = "scatter") -> ModelOutput:
    """Training forward on one rank (the reference's ``lina=False``; at
    expert parallelism 1 the all-to-alls are the identity): loss (CE +
    aux), aux loss, and per-MoE-layer top-1 expert choices
    [n_moe_layers, B*S].  ``batch`` holds ``tokens`` and ``labels`` [B, S]
    tensors on the params' device.

    Differentiable in ``params`` (fp32 masters cast to ``cfg.dtype`` for
    compute).  With ``cfg.remat`` each layer group runs under
    ``torch.utils.checkpoint`` (non-reentrant): only the group boundaries
    are kept and the backward recomputes the group, kernels included, as
    the reference's ``jax.checkpoint`` over the scan body."""
    _check_family(cfg)
    p = cast_for_compute(cfg, params)
    dtype = DTYPES[cfg.dtype]
    tokens = batch["tokens"].long()
    labels = batch["labels"]
    x = p.embed[tokens].to(dtype)
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1s = []
    for gi in range(cfg.n_layers // every):
        gp = tree_idx(p.stack, gi)
        if cfg.remat:
            x, a, top1 = checkpoint(_group_apply, cfg, gp, x,
                                    dispatch_backend, use_reentrant=False)
        else:
            x, a, top1 = _group_apply(cfg, gp, x, dispatch_backend)
        aux = aux + a
        if top1 is not None:
            top1s.append(top1)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    loss = chunked_ce_loss(x, unembed_weight(p), labels,
                           torch.ones(labels.shape, device=x.device),
                           remat=cfg.remat)
    experts = torch.stack(top1s) if top1s else None
    return ModelOutput(loss + aux, aux, experts)
