"""The LM stack of the port's families, in PyTorch: the transformer (the
``"moe"`` family: the paper's §7.1 models, mixtral-8x22b and
llama4-maverick, whose groups interleave a dense block with an MoE block
and add a shared expert; and the ``"dense"`` family: qwen and granite, a
dense FFN in every block and no expert choices), the hybrid Mamba2 +
shared-attention stack (zamba2) and the attention-free RWKV6 stack.  The
transformer also carries the two modality stubs: llava-next-34b's vision
frontend (precomputed patch embeddings through ``patch_proj``, prepended
to the text) and hubert-xlarge's audio frontend (precomputed frames of
``FRAME_DIM`` through ``frame_proj``, every ``MASK_EVERY``-th frame masked
with ``mask_emb`` in training; a bidirectional encoder with no decode).

Parameters are NamedTuples of tensors in the reference's layout: every
leaf of a transformer ``LMParams.stack`` carries a leading layer-group dim G
(one group = ``moe.every`` transformer blocks; ``attn``/``ln*`` add an
``every`` dim); the hybrid and RWKV stacks carry a leading layer dim L.
``forward_train`` is the transformer family's training forward (loss plus
per-layer top-1 expert choices, differentiable in the params) that the
train step runs.  Every family is served through the reference's model
entry points ``forward_prefill`` (last-position logits), ``init_cache``
and ``decode_step``; the transformer family also layer by layer in
``runtime.server``.  Their recurrences run the WKV and SSD kernels and
their prefill attention the flash kernel on the kernel route
(``cfg.moe.compute_backend`` "auto"/"pallas"), the plain versions on the
"xla" route.

The transformer serve entry points take the reference's keywords: with a
``serve_plan`` (one ``PlanArrays`` for every MoE layer, or a stacked one,
a plan a layer) each MoE layer is ``core.serving.serve_moe_layer``, else
``core.moe.moe_layer``.  With a ``mesh`` the batch is the whole batch on
every rank and ``params`` hold this rank's experts
(``convert.shard_params``, with ``fsdp`` also cut over `data`): a
plan-honoring layer shards the tokens itself, and ``moe_layer`` gets the
reference's token shard (batch over `data` where B tiles it, sequence over
`model` where S tiles it), its outputs all-gathered back.  Training the
hybrid and RWKV families needs backward kernels for WKV and SSD (ROADMAP:
"training of the RWKV6 and hybrid Mamba2 families"), so ``forward_train``
refuses them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import axes
from repro_torch.core.moe import (MoEOutput, MoEParams, gather_axis,
                                  gather_hidden, moe_layer)
from repro_torch.core.serving import serve_moe_layer
from repro_torch.devices import resolve_device
from repro_torch.kernels.ops import kernel_route
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (AttnParams, KVCache, attention,
                                          decode_attention)
from repro_torch.models.layers import dense_init, ffn_branch, rms_norm
from repro_torch.tree import tree_map

FRAME_DIM = 512      # audio stub frame-embedding dim
CE_CHUNK = 1024      # sequence chunk for the memory-bounded CE
MASK_EVERY = 13      # hubert deterministic mask pattern

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


class HybridParams(NamedTuple):
    mamba: ssm_mod.MambaParams          # stacked [L, ...]
    ln_m: torch.Tensor                  # [L, d]
    shared_attn: AttnParams             # single shared block
    shared_ffn: FFNParams
    ln_s1: torch.Tensor                 # [d]
    ln_s2: torch.Tensor                 # [d]


class RWKVStack(NamedTuple):
    blocks: rwkv_mod.RWKVParams         # stacked [L, ...]
    ln1: torch.Tensor                   # [L, d]
    ln2: torch.Tensor                   # [L, d]


class LMParams(NamedTuple):
    embed: torch.Tensor                 # [V, d]
    patch_proj: Optional[torch.Tensor]  # [d, d] vision stub
    frame_proj: Optional[torch.Tensor]  # [FRAME_DIM, d] audio stub
    mask_emb: Optional[torch.Tensor]    # [FRAME_DIM] hubert mask embedding
    stack: object                       # GroupParams, HybridParams or
    #                                     RWKVStack
    final_norm: torch.Tensor            # [d]
    lm_head: Optional[torch.Tensor]     # [d, V] or None (tied)


class LMCache(NamedTuple):
    """Decode state, with the reference's fields."""
    kv: Optional[KVCache]               # [G, every, B, S_max, KV, hd] or
    #                                     [n_taps, B, S_max, KV, hd]
    mamba: Optional[ssm_mod.MambaState]      # stacked [L, ...]
    rwkv: Optional[rwkv_mod.RWKVState]       # stacked [L, ...]
    pos: torch.Tensor                   # [B] next position


class ModelOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    aux_loss: torch.Tensor
    expert_choices: Optional[torch.Tensor]   # [n_moe_layers, T] top-1
    logits: Optional[torch.Tensor] = None    # [B, V] last position (prefill)


def tree_idx(tree, i):
    return tree_map(lambda a: a[i], tree)


def _check_family(cfg, serve: bool = False) -> None:
    """The transformer family (frontends included) runs in every entry
    point here; the hybrid and RWKV families in ``init_params`` and the
    serving entry points (``serve``) only."""
    if cfg.frontend not in ("none", "vision_stub", "audio_stub"):
        raise NotImplementedError(f"{cfg.name}: unknown frontend "
                                  f"{cfg.frontend!r}")
    if (cfg.layer_pattern or cfg.attention_free) and not serve:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family needs backward "
            f"kernels for WKV and SSD (ROADMAP: \"training of the RWKV6 "
            f"and hybrid Mamba2 families\"); it is "
            f"served through forward_prefill / init_cache / decode_step")


def _check_served_here(cfg) -> None:
    _check_family(cfg, serve=True)


def _check_decodes(cfg) -> None:
    """An encoder-only config (``causal=False``: hubert) has no decode
    step, as the reference has no decode shapes for it."""
    _check_served_here(cfg)
    if not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: a bidirectional encoder has no autoregressive "
            f"decode step (init_cache / decode_step); serve it through "
            f"forward_prefill")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator, device="cuda") -> LMParams:
    """Random weights with the reference's distributions: N(0, 1/fan_in)
    dense layers, N(0, 1/d) embeddings and router, ones for norms, on
    ``device`` (the card by default; raises without one).  ``gen`` is a
    generator on that device.  The numbers are not JAX's; tests convert
    the reference's with ``repro_torch.convert.from_reference``."""
    _check_family(cfg, serve=True)
    device = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.d_model
    hd = cfg.resolved_head_dim

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

    def lm_params(stack):
        # the unembedding is drawn after the stack
        lm_head = None if cfg.tie_embeddings else dense((d, cfg.vocab_size))
        return LMParams(embed, patch_proj, frame_proj, mask_emb, stack,
                        ones(d), lm_head)

    embed = dense((cfg.vocab_size, d), scale_axis=-1)
    # the frontends' projections, drawn after the embedding
    patch_proj = dense((d, d)) if cfg.frontend == "vision_stub" else None
    frame_proj = dense((FRAME_DIM, d)) if cfg.frontend == "audio_stub" \
        else None
    mask_emb = zeros(FRAME_DIM) if cfg.frontend == "audio_stub" else None
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    n_l = cfg.n_layers
    if cfg.layer_pattern:                                  # hybrid (zamba2)
        stack = HybridParams(
            mamba=ssm_mod.init_mamba_params(gen, cfg, (n_l,), dtype, device),
            ln_m=ones(n_l, d),
            shared_attn=AttnParams(dense((d, hq)), dense((d, hkv)),
                                   dense((d, hkv)), dense((hq, d)),
                                   None, None, None, None, None),
            shared_ffn=ffn((), cfg.d_ff), ln_s1=ones(d), ln_s2=ones(d))
        return lm_params(stack)
    if cfg.attention_free:                                 # rwkv6
        stack = RWKVStack(
            blocks=rwkv_mod.init_rwkv_params(gen, cfg, (n_l,), dtype, device),
            ln1=ones(n_l, d), ln2=ones(n_l, d))
        return lm_params(stack)

    every = cfg.moe.every if cfg.moe.enabled else 1
    g = cfg.n_layers // every
    n_dense = (every - 1) if cfg.moe.enabled else every
    f_moe = cfg.moe.d_ff or cfg.d_ff
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
    return lm_params(stack)


def cast_for_compute(cfg, params: LMParams) -> LMParams:
    """Master params -> compute dtype; non-float leaves untouched."""
    dt = DTYPES[cfg.dtype]

    def one(p):
        return p.to(dt) if p.is_floating_point() else p
    return tree_map(one, params)


def embed_inputs(cfg, params: LMParams, *, tokens=None, patches=None,
                 frames=None, mask=None):
    """The model's input embedding x [B, S, d] in ``cfg.dtype``, as the
    reference's: the audio stub projects frames [B, S, FRAME_DIM] (frames
    where ``mask`` [B, S] is True replaced by ``mask_emb``) through
    ``frame_proj``; else tokens [B, S_text] are looked up, and the vision
    stub prepends patches [B, P, d] projected through ``patch_proj``.
    ``params`` are the compute copy (``cast_for_compute``).

    The products are taken in the dtype JAX promotes the operands to (fp32
    frames against a bf16 ``frame_proj`` multiply in fp32, where torch would
    refuse the mix), then cast to ``cfg.dtype``; patches are first cast to
    ``patch_proj``'s dtype, as there."""
    dtype = DTYPES[cfg.dtype]
    if cfg.frontend == "audio_stub":
        f = frames
        if mask is not None:
            f = torch.where(mask[..., None], params.mask_emb.to(f.dtype), f)
        w = params.frame_proj
        pt = torch.promote_types(f.dtype, w.dtype)
        return (f.to(pt) @ w.to(pt)).to(dtype)
    x = params.embed[tokens.long()].to(dtype)
    if cfg.frontend == "vision_stub":
        pe = (patches.to(params.patch_proj.dtype) @ params.patch_proj
              ).to(dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def frame_mask(shape, device):
    """hubert's training mask [B, S]: every ``MASK_EVERY``-th frame (the
    last of each run of ``MASK_EVERY``)."""
    pos = torch.arange(shape[1], device=device)
    return ((pos % MASK_EVERY) == (MASK_EVERY - 1))[None].expand(shape)


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
# the transformer family's layer groups
# ---------------------------------------------------------------------------

def _moe_whole_batch(h, moe_p: MoEParams, cfg, *, mesh, lina: bool,
                     fsdp: bool, top_k=None, shortcut=None,
                     dispatch_backend: str = "scatter") -> MoEOutput:
    """``moe_layer`` on the whole batch h [B, S, d].  With a mesh this rank
    takes the reference's token shard (batch over `data` if B tiles it,
    sequence over `model` if S tiles it, else the whole dim), and y and
    the ids come back all-gathered: [B, S, d] and [B * S, k] in (b, s)
    order (the reference keeps its ids in shard order).  Without one,
    ``lina`` and ``fsdp`` have nothing to act on, as on the reference's
    one-device default mesh."""
    if mesh is None:
        return moe_layer(h, moe_p, cfg.moe, ffn_type=cfg.ffn_type,
                         dispatch_backend=dispatch_backend, top_k=top_k,
                         shortcut_params=shortcut)
    b, s, d = h.shape
    dp_n, ep = mesh.size(axes.DATA), mesh.size(axes.EP_AXIS)
    bq, sq = b % dp_n == 0, s % ep == 0
    if bq:
        i, n = mesh.index(axes.DATA), b // dp_n
        h = h[i * n:(i + 1) * n]
    if sq:
        i, n = mesh.index(axes.EP_AXIS), s // ep
        h = h[:, i * n:(i + 1) * n]
    out = moe_layer(h, moe_p, cfg.moe, ffn_type=cfg.ffn_type,
                    dispatch_backend=dispatch_backend, top_k=top_k,
                    mesh=mesh, lina=lina, fsdp=fsdp,
                    shortcut_params=shortcut)
    bl, sl = h.shape[:2]
    y = out.y
    eidx = out.expert_idx.reshape(bl, sl, -1)
    for go, axis, dim in ((sq, axes.EP_AXIS, 1), (bq, axes.DATA, 0)):
        if go:
            y, eidx = (gather_axis(a, mesh, axis, dim) for a in (y, eidx))
    return MoEOutput(y, out.aux_loss, eidx.reshape(b * s, -1), None)


def _plan_of(serve_plan, gi: int):
    if serve_plan is None or not serve_plan.stacked:
        return serve_plan
    return serve_plan.layer(gi)


def _moe_sublayer(cfg, gp: GroupParams, h, plan, *, mesh, lina: bool,
                  fsdp: bool, serve_top_k, fuse_shortcut: bool,
                  dispatch_backend: str, replicated: bool):
    """The MoE sublayer on h [B, S, d] -> (moe_y, aux, top-1 id per token
    [B * S]).  Under ``plan`` it is the plan-honoring layer; else
    ``moe_layer``, with ``fuse_shortcut`` taking the ScMoE shortcut into
    it.  ``replicated``: h is the whole batch on every rank of the mesh
    (the serve entry points), not this rank's own (training).  The shared
    expert is added outside the plan dispatch."""
    b, s, d = h.shape
    moe_p = gp.moe
    sc = gp.shared if fuse_shortcut and cfg.moe.shortcut else None
    if plan is not None:
        if fsdp and mesh is not None:
            moe_p = moe_p._replace(
                wi=gather_hidden(moe_p.wi, mesh, 2),
                wu=None if moe_p.wu is None else gather_hidden(moe_p.wu,
                                                               mesh, 2),
                wo=gather_hidden(moe_p.wo, mesh, 1))
        y2, eidx, _ = serve_moe_layer(h.reshape(b * s, d), moe_p, cfg.moe,
                                      plan, ffn_type=cfg.ffn_type,
                                      top_k=serve_top_k, mesh=mesh)
        moe_y, aux, sc = y2.reshape(b, s, d), torch.zeros(
            (), device=h.device), None
    elif replicated:
        out = _moe_whole_batch(h, moe_p, cfg, mesh=mesh, lina=lina,
                               fsdp=fsdp, top_k=serve_top_k, shortcut=sc,
                               dispatch_backend=dispatch_backend)
        moe_y, aux, eidx = out.y, out.aux_loss, out.expert_idx
    else:
        out = moe_layer(h, moe_p, cfg.moe, ffn_type=cfg.ffn_type,
                        dispatch_backend=dispatch_backend, top_k=serve_top_k,
                        mesh=mesh, lina=lina, fsdp=fsdp, shortcut_params=sc)
        moe_y, aux, eidx = out.y, out.aux_loss, out.expert_idx
    if gp.shared is not None and sc is None:
        moe_y = moe_y + _ffn_apply(gp.shared, h, cfg.ffn_type)
    return moe_y, aux, eidx[:, 0].to(torch.int32)


def _group_apply(cfg, gp: GroupParams, x, *, plan=None, serve_top_k=None,
                 dispatch_backend: str = "scatter", mesh=None,
                 lina: bool = True, fsdp: bool = False,
                 use_kernel: bool = False, replicated: bool = False):
    """One layer group (``moe.every`` blocks) on [B, S, d] ->
    (x, aux loss, top-1 expert per token or None).  ``use_kernel`` runs
    the flash kernel for attention (no backward); the rest is
    ``_moe_sublayer``'s, the ScMoE shortcut fused into ``moe_layer``."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1 = None
    for j in range(every):
        h = rms_norm(x, gp.ln1[j], cfg.norm_eps)
        y, _ = attention(tree_idx(gp.attn, j), h, cfg, use_kernel=use_kernel)
        x = x + y
        h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
        if not (cfg.moe.enabled and j == every - 1):
            x = x + _ffn_apply(tree_idx(gp.ffn, j), h, cfg.ffn_type)
            continue
        moe_y, a, top1 = _moe_sublayer(
            cfg, gp, h, plan, mesh=mesh, lina=lina, fsdp=fsdp,
            serve_top_k=serve_top_k, fuse_shortcut=True,
            dispatch_backend=dispatch_backend, replicated=replicated)
        x = x + moe_y
        aux = aux + a
    return x, aux, top1


def run_stack(cfg, stack: GroupParams, x, *, serve_plan=None,
              remat: bool = False, **kw):
    """The transformer stack on x [B, S, d] -> (x, aux, expert choices
    [n_moe_layers, B * S] or None).  ``kw`` are ``_group_apply``'s; a
    stacked ``serve_plan`` gives MoE layer g its plan g.  With ``remat``
    each group runs under ``torch.utils.checkpoint`` (non-reentrant)."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1s = []
    for gi in range(cfg.n_layers // every):
        gp = tree_idx(stack, gi)
        plan = _plan_of(serve_plan, gi)
        if remat:
            x, a, top1 = checkpoint(_group_apply, cfg, gp, x, plan=plan,
                                    use_reentrant=False, **kw)
        else:
            x, a, top1 = _group_apply(cfg, gp, x, plan=plan, **kw)
        aux = aux + a
        if top1 is not None:
            top1s.append(top1)
    return x, aux, torch.stack(top1s) if top1s else None


def forward_train(cfg, params: LMParams, batch: dict, *,
                  dispatch_backend: str = "scatter", mesh=None,
                  lina: bool = True, fsdp: bool = False) -> ModelOutput:
    """Training forward on this rank's batch: loss (CE + aux), aux loss,
    and per-MoE-layer top-1 expert choices [n_moe_layers, B*S].  ``batch``
    holds ``tokens`` and ``labels`` [B, S] tensors on the params' device.
    Without ``mesh`` it is the single-rank model; with one, the MoE layers
    run expert parallel over it (``core.moe.moe_layer``'s ``mesh``,
    ``lina`` and ``fsdp``; ``params`` hold this rank's experts).  The loss
    is this rank's: its mean over the ranks is the global loss.

    Differentiable in ``params`` (fp32 masters cast to ``cfg.dtype`` for
    compute).  With ``cfg.remat`` each layer group runs under
    ``torch.utils.checkpoint`` (non-reentrant): only the group boundaries
    are kept and the backward recomputes the group, kernels and
    all-to-alls included, as the reference's ``jax.checkpoint`` over the
    scan body.

    The frontends follow the reference's branches: hubert's batch holds
    ``frames`` [B, S, FRAME_DIM] and ``labels`` [B, S]; every
    ``MASK_EVERY``-th frame is masked with ``mask_emb`` and the loss is
    taken on the masked frames only.  llava's holds ``tokens``, ``patches``
    [B, P, d] and ``labels`` [B, S_text]: the patch prefix gets zero
    labels and a zero loss mask, the text next-token labels."""
    _check_family(cfg)
    p = cast_for_compute(cfg, params)
    tokens = batch.get("tokens")
    if cfg.frontend == "audio_stub":
        frames = batch["frames"]
        mask = frame_mask(frames.shape[:2], frames.device)
        x = embed_inputs(cfg, p, frames=frames, mask=mask)
        labels, loss_mask = batch["labels"], mask.float()
    elif cfg.frontend == "vision_stub":
        x = embed_inputs(cfg, p, tokens=tokens, patches=batch["patches"])
        lab_txt = batch["labels"]
        pad = torch.zeros((tokens.shape[0], batch["patches"].shape[1]),
                          dtype=lab_txt.dtype, device=lab_txt.device)
        labels = torch.cat([pad, lab_txt], dim=1)
        loss_mask = torch.cat([torch.zeros(pad.shape, device=x.device),
                               torch.ones(lab_txt.shape, device=x.device)],
                              dim=1)
    else:
        x = embed_inputs(cfg, p, tokens=tokens)
        labels = batch["labels"]
        loss_mask = torch.ones(labels.shape, device=x.device)
    x, aux, experts = run_stack(cfg, p.stack, x, remat=cfg.remat,
                                dispatch_backend=dispatch_backend, mesh=mesh,
                                lina=lina, fsdp=fsdp)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    loss = chunked_ce_loss(x, unembed_weight(p), labels, loss_mask,
                           remat=cfg.remat)
    return ModelOutput(loss + aux, aux, experts)


# ---------------------------------------------------------------------------
# the hybrid (zamba2) and RWKV6 families: prefill and decode
# ---------------------------------------------------------------------------

def _taps(cfg) -> list:
    """Layers after which the shared attention block runs ("A" or "*")."""
    return [ch in "A*" for ch in cfg.layer_pattern]


def _shared_block(cfg, hp: HybridParams, x, use_kernel: bool):
    h = rms_norm(x, hp.ln_s1, cfg.norm_eps)
    y, _ = attention(hp.shared_attn, h, cfg, use_kernel=use_kernel)
    x = x + y
    h = rms_norm(x, hp.ln_s2, cfg.norm_eps)
    return x + _ffn_apply(hp.shared_ffn, h, cfg.ffn_type)


def _run_hybrid(cfg, hp: HybridParams, x):
    """Mamba2 layers, the shared block after each tap.  x: [B, S, d]."""
    use_kernel = kernel_route(cfg)
    for li, tap in enumerate(_taps(cfg)):
        h = rms_norm(x, hp.ln_m[li], cfg.norm_eps)
        y, _ = ssm_mod.mamba_block(tree_idx(hp.mamba, li), cfg, h)
        x = x + y
        if tap:
            x = _shared_block(cfg, hp, x, use_kernel)
    return x


def _run_rwkv(cfg, st: RWKVStack, x):
    """RWKV6 layers: time-mix then channel-mix.  x: [B, S, d]."""
    for li in range(cfg.n_layers):
        bp = tree_idx(st.blocks, li)
        h = rms_norm(x, st.ln1[li], cfg.norm_eps)
        y, _, _ = rwkv_mod.time_mix(bp, cfg, h)
        x = x + y
        h = rms_norm(x, st.ln2[li], cfg.norm_eps)
        y, _ = rwkv_mod.channel_mix(bp, h)
        x = x + y
    return x


def forward_prefill(cfg, params: LMParams, batch: dict, *, mesh=None,
                    lina: bool = False, serve_plan=None, serve_top_k=None,
                    fsdp: bool = False) -> ModelOutput:
    """Serving prefill: last-position logits [B, V] in ``cfg.dtype``
    (``ModelOutput.logits``), the aux loss and, for the transformer
    family, the per-MoE-layer top-1 expert choices [n_moe_layers, B * S].
    ``batch`` holds ``tokens`` [B, S] on the params' device (the whole
    batch on every rank of a mesh); hubert's ``frames`` [B, S, FRAME_DIM]
    instead (nothing masked), llava's ``tokens`` and ``patches`` [B, P, d]
    (the logits are the last text position's).  The transformer keywords
    are the reference's (see the module doc); a stacked ``serve_plan``
    gives each MoE layer its own plan (the reference's prefill takes one
    plan for every layer).  Builds no cache, as the reference's (decode starts from
    ``init_cache``).  The WKV / SSD and flash kernels have no backward:
    call it under ``torch.inference_mode`` when the params require
    grad."""
    _check_served_here(cfg)
    p = cast_for_compute(cfg, params)
    x = embed_inputs(cfg, p, tokens=batch.get("tokens"),
                     patches=batch.get("patches"),
                     frames=batch.get("frames"))
    aux = torch.zeros((), device=x.device)
    experts = None
    if isinstance(p.stack, HybridParams):
        x = _run_hybrid(cfg, p.stack, x)
    elif isinstance(p.stack, RWKVStack):
        x = _run_rwkv(cfg, p.stack, x)
    else:
        x, aux, experts = run_stack(
            cfg, p.stack, x, mesh=mesh, lina=lina, serve_plan=serve_plan,
            serve_top_k=serve_top_k, fsdp=fsdp, use_kernel=kernel_route(cfg),
            replicated=True)
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    logits = x[:, -1] @ unembed_weight(p)
    return ModelOutput(None, aux, experts, logits)


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda") -> LMCache:
    """Empty decode state on ``device`` (the card by default; raises
    without one): the transformer's KV cache [n_groups, every, B, S_max,
    KV, hd], or the hybrid's shared-block KV cache [n_taps, B, S_max, KV,
    hd] and its Mamba2 states, or the RWKV states.  KV caches are in
    ``dtype``, S_max = seq_len capped at the sliding window; recurrent
    states in float32, as the reference keeps them.  Raises for an
    encoder-only config (hubert)."""
    _check_decodes(cfg)
    device = resolve_device(device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    s = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    kv_row = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)

    def per_layer(state):
        return tree_map(lambda a: a.expand(cfg.n_layers, *a.shape)
                        .contiguous(), state)
    if not (cfg.layer_pattern or cfg.attention_free):
        every = cfg.moe.every if cfg.moe.enabled else 1
        shape = (cfg.n_layers // every, every, *kv_row)
        return LMCache(kv=KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device)), mamba=None,
            rwkv=None, pos=pos)
    if cfg.layer_pattern:
        shape = (sum(_taps(cfg)), *kv_row)
        kv = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))
        ms = per_layer(ssm_mod.init_mamba_state(cfg, batch, device=device))
        return LMCache(kv=kv, mamba=ms, rwkv=None, pos=pos)
    rs = per_layer(rwkv_mod.init_rwkv_state(cfg, batch, device=device))
    return LMCache(kv=None, mamba=None, rwkv=rs, pos=pos)


def _decode_groups(cfg, stack: GroupParams, cache: LMCache, x, *, mesh,
                   lina, serve_plan, serve_top_k, fsdp):
    """The transformer's decode step on x [B, 1, d] -> (x, new cache,
    expert choices [n_moe_layers, B] or None)."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    ks, vs, top1s = [], [], []
    for gi in range(cfg.n_layers // every):
        gp = tree_idx(stack, gi)
        ks_g, vs_g = [], []
        for j in range(every):
            h = rms_norm(x, gp.ln1[j], cfg.norm_eps)
            y, kv_new = decode_attention(
                tree_idx(gp.attn, j), h,
                KVCache(cache.kv.k[gi, j], cache.kv.v[gi, j]), cache.pos,
                cfg)
            ks_g.append(kv_new.k)
            vs_g.append(kv_new.v)
            x = x + y
            h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
            if not (cfg.moe.enabled and j == every - 1):
                x = x + _ffn_apply(tree_idx(gp.ffn, j), h, cfg.ffn_type)
                continue
            moe_y, _, top1 = _moe_sublayer(
                cfg, gp, h, _plan_of(serve_plan, gi), mesh=mesh, lina=lina,
                fsdp=fsdp, serve_top_k=serve_top_k, fuse_shortcut=False,
                dispatch_backend="scatter", replicated=True)
            x = x + moe_y
            top1s.append(top1)
        ks.append(torch.stack(ks_g))
        vs.append(torch.stack(vs_g))
    new_cache = LMCache(kv=KVCache(torch.stack(ks), torch.stack(vs)),
                        mamba=None, rwkv=None, pos=cache.pos + 1)
    return x, new_cache, torch.stack(top1s) if top1s else None


def decode_step(cfg, params: LMParams, cache: LMCache, token, *, mesh=None,
                lina: bool = False, serve_plan=None, serve_top_k=None,
                fsdp: bool = False) -> tuple:
    """One decode step.  token: [B] on the params' device (the whole batch
    on every rank of a mesh).  Returns (logits [B, V], cache,
    expert_choices): the per-MoE-layer top-1 expert of each row
    [n_moe_layers, B] for the transformer family (callers roll path-ID
    state with it), None for the hybrid and RWKV stacks, as the reference
    returns.  The transformer keywords are the reference's (see the module
    doc; a stacked ``serve_plan`` gives each MoE layer its own plan); its
    attention is the plain ``decode_attention``.  Mamba2 layers run
    ``mamba_decode`` (plain), the shared block the plain
    ``decode_attention``; each RWKV6 layer runs the WKV op at T = 1 from
    its cached state (the kernel on the kernel route).  llava decodes text
    tokens only, as the reference's; an encoder-only config raises."""
    _check_decodes(cfg)
    p = cast_for_compute(cfg, params)
    x = p.embed[token.long()][:, None].to(DTYPES[cfg.dtype])     # [B,1,d]
    pos = cache.pos
    eps = cfg.norm_eps
    if isinstance(p.stack, GroupParams):
        x, new_cache, experts = _decode_groups(
            cfg, p.stack, cache, x, mesh=mesh, lina=lina,
            serve_plan=serve_plan, serve_top_k=serve_top_k, fsdp=fsdp)
        x = rms_norm(x, p.final_norm, eps)
        return x[:, 0] @ unembed_weight(p), new_cache, experts
    if isinstance(p.stack, HybridParams):
        hp = p.stack
        states, ks, vs = [], [], []
        for li, tap in enumerate(_taps(cfg)):
            h = rms_norm(x, hp.ln_m[li], eps)
            y, ms_new = ssm_mod.mamba_decode(tree_idx(hp.mamba, li), cfg, h,
                                             tree_idx(cache.mamba, li))
            states.append(ms_new)
            x = x + y
            if tap:
                h = rms_norm(x, hp.ln_s1, eps)
                y, kv_new = decode_attention(
                    hp.shared_attn, h, tree_idx(cache.kv, len(ks)), pos, cfg)
                ks.append(kv_new.k)
                vs.append(kv_new.v)
                x = x + y
                h2 = rms_norm(x, hp.ln_s2, eps)
                x = x + _ffn_apply(hp.shared_ffn, h2, cfg.ffn_type)
        new_cache = LMCache(
            kv=KVCache(torch.stack(ks), torch.stack(vs)),
            mamba=tree_map(lambda *a: torch.stack(a), *states), rwkv=None,
            pos=pos + 1)
    else:
        st = p.stack
        use_kernel = kernel_route(cfg)
        hh, hd = rwkv_mod._heads(cfg)
        states = []
        for li in range(cfg.n_layers):
            bp = tree_idx(st.blocks, li)
            rs = tree_idx(cache.rwkv, li)
            h = rms_norm(x, st.ln1[li], eps)
            # single-token time-mix through the sequence op (T = 1); the
            # states are stored float32 and cast at use
            x_prev = rs.x_tm[:, None].to(h.dtype)
            lw, k, v, r, g = rwkv_mod._tm_projections(bp, cfg, h, x_prev)
            y, s_t = rwkv_mod.wkv_chunked(r, k, v, lw, bp.u, hh, hd, 1, rs.s,
                                          use_kernel=use_kernel)
            y = rms_norm(y.to(x.dtype) * g.to(x.dtype), bp.ln_x, eps)
            x = x + y @ bp.wo
            h2 = rms_norm(x, st.ln2[li], eps)
            y2, last_cm = rwkv_mod.channel_mix(bp, h2, rs.x_cm.to(h2.dtype))
            x = x + y2
            states.append(rwkv_mod.RWKVState(s_t, h[:, -1].float(),
                                             last_cm.float()))
        new_cache = LMCache(
            kv=None, mamba=None,
            rwkv=tree_map(lambda *a: torch.stack(a), *states), pos=pos + 1)
    x = rms_norm(x, p.final_norm, eps)
    logits = x[:, 0] @ unembed_weight(p)
    return logits, new_cache, None
