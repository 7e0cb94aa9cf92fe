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
``forward_train`` is the training forward (loss plus, for the transformer
family, per-layer top-1 expert choices; differentiable in the params)
that the train step runs.  Every family is served through the reference's model
entry points ``forward_prefill`` (last-position logits), ``init_cache``
and ``decode_step``; the transformer family also layer by layer in
``runtime.server``.  ``forward_train`` trains every family: the hybrid and
RWKV stacks return the CE loss with a zero aux loss and no expert
choices, as the reference's do.  Their recurrences run the WKV and SSD kernels and
their prefill attention the flash kernel on the kernel route
(``cfg.moe.compute_backend`` "auto"/"pallas"), the plain versions on the
"xla" route.

The transformer serve entry points take the reference's keywords: with a
``serve_plan`` (one ``PlanArrays`` for every MoE layer, or a stacked one,
a plan a layer) each MoE layer is ``core.serving.serve_moe_layer``, else
``core.moe.moe_layer``.

With a ``layout`` (``launch.sharding.Layout``: a mesh, the spec tree of
the stored params, the axes the batch rows are split over) every leaf is
stored as its spec says and the entry points compute with the shards:
each layer group's (each layer's) FSDP splits are all-gathered when it
runs (again in the backward under remat; the gradient reduce-scattered),
attention and the dense FFNs run tensor parallel over the `model` (and
`tp`) ranks where their weights are split there, the embedding is looked
up vocab-parallel (a masked local lookup and one all-reduce), the
training loss is a vocab-parallel cross-entropy (a max, a sum-of-exp and
a gold-logit all-reduce a chunk) and the serve logits are all-gathered
over the vocab.  ``batch`` holds this rank's rows (``layout.batch_axes``;
the reference's ``batch_specs``: B / dp rows where they split, else the
whole batch), replicated over the other axes.  The MoE layer takes the
reference's token shard of them (batch over `data` where B tiles it and
the rows are not split there already, sequence over `model` where S tiles
it and the rows are not split there), its outputs all-gathered back; its
experts are this rank's E / ep, on a mesh with `tp` each expert's hidden
slice (``core.moe``).  Decode reads a cache cut by ``cache_specs``: its
sequence over the model-parallel ranks (``models.attention``), or its kv
heads too (the dry run's variants).  With ``cfg.seq_parallel`` the
transformer stack runs Megatron-SP in training and prefill
(``_stack_layout``, ``launch.sharding.Layout.for_sequence``): its carry
between layer groups is this rank's slice of the sequence.  The hybrid
and RWKV stacks are FSDP only, but for zamba2's shared block.
The expert-parallel layout (``launch.sharding.expert_layout``) is the
special case whose experts alone are split.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import axes
from repro_torch.core.collectives import gather_axis, gather_grad
from repro_torch.core.moe import MoEOutput, MoEParams, moe_layer
from repro_torch.core.serving import serve_moe_layer
from repro_torch.devices import resolve_device
from repro_torch.kernels.ops import kernel_route
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (AttnParams, CacheSplit, KVCache,
                                          attention, decode_attention)
from repro_torch.models.layers import dense_init, ffn_parallel, rms_norm
from repro_torch.obs import region
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


def _check_family(cfg) -> None:
    """Every family (the transformer, frontends included, the hybrid and
    the RWKV stacks) runs in every entry point here; an unknown frontend
    raises."""
    if cfg.frontend not in ("none", "vision_stub", "audio_stub"):
        raise NotImplementedError(f"{cfg.name}: unknown frontend "
                                  f"{cfg.frontend!r}")


def _check_decodes(cfg) -> None:
    """An encoder-only config (``causal=False``: hubert) has no decode
    step, as the reference has no decode shapes for it."""
    _check_family(cfg)
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
    _check_family(cfg)
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


def lookup(cfg, embed, tokens, layout=None):
    """Rows of the embedding for ``tokens``; with the vocab split over
    ``layout``'s model-parallel ranks, a masked lookup of this rank's rows
    summed over them (one all-reduce).  On a Megatron-SP view the rows of
    this rank's sequence slice of ``tokens`` [B, S]: the masked lookup's
    sum reduce-scattered to it, a whole vocab looked up on it."""
    v_loc = embed.shape[0]
    if layout is None:
        return embed[tokens.long()]
    if v_loc == cfg.vocab_size:
        return embed[layout.own_seq(tokens).long()]
    t = tokens.long() - layout.i * v_loc
    inside = (t >= 0) & (t < v_loc)
    x = embed[t.clamp(0, v_loc - 1)] * inside[..., None].to(embed.dtype)
    return layout.reduce_out(x)


def embed_inputs(cfg, params: LMParams, *, tokens=None, patches=None,
                 frames=None, mask=None, layout=None):
    """The model's input embedding x [B, S, d] in ``cfg.dtype``, as the
    reference's: the audio stub projects frames [B, S, FRAME_DIM] (frames
    where ``mask`` [B, S] is True replaced by ``mask_emb``) through
    ``frame_proj``; else tokens [B, S_text] are looked up, and the vision
    stub prepends patches [B, P, d] projected through ``patch_proj``.
    ``params`` are the compute copy (``cast_for_compute``).

    The products are taken in the dtype JAX promotes the operands to (fp32
    frames against a bf16 ``frame_proj`` multiply in fp32, where torch would
    refuse the mix), then cast to ``cfg.dtype``; patches are first cast to
    ``patch_proj``'s dtype, as there.  On a Megatron-SP view it is this
    rank's sequence slice of x (the frontends' x is cut after it is
    whole)."""
    dtype = DTYPES[cfg.dtype]
    if cfg.frontend == "audio_stub":
        f = frames
        if mask is not None:
            f = torch.where(mask[..., None], params.mask_emb.to(f.dtype), f)
        w = params.frame_proj
        pt = torch.promote_types(f.dtype, w.dtype)
        x = (f.to(pt) @ w.to(pt)).to(dtype)
        return x if layout is None else layout.own_seq(x)
    if cfg.frontend != "vision_stub":
        return lookup(cfg, params.embed, tokens, layout).to(dtype)
    x = lookup(cfg, params.embed, tokens, layout and layout.base).to(dtype)
    pe = (patches.to(params.patch_proj.dtype) @ params.patch_proj).to(dtype)
    x = torch.cat([pe, x], dim=1)
    return x if layout is None else layout.own_seq(x)


def frame_mask(shape, device):
    """hubert's training mask [B, S]: every ``MASK_EVERY``-th frame (the
    last of each run of ``MASK_EVERY``)."""
    pos = torch.arange(shape[1], device=device)
    return ((pos % MASK_EVERY) == (MASK_EVERY - 1))[None].expand(shape)


def unembed_weight(params: LMParams):
    return params.embed.T if params.lm_head is None else params.lm_head


def _ffn_apply(p: FFNParams, x, ffn_type, layout=None, f: int = 0):
    """The dense FFN of hidden width ``f`` (tensor parallel where
    ``layout`` splits it: ``models.layers.ffn_parallel``)."""
    return ffn_parallel(x, p.w_in, p.w_up, p.w_out, ffn_type, f, layout)


def _ce_chunk(xc, w_unembed, lab, m):
    logits = (xc @ w_unembed).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum()


def _ce_chunk_parallel(xc, w_unembed, lab, m, layout):
    """``_ce_chunk`` with the vocab split over ``layout``'s model-parallel
    ranks: the max, the sum of exp and the gold logit each summed (the max
    maxed) over them."""
    logits = (xc @ w_unembed).float()
    v_loc = logits.shape[-1]
    mx = logits.detach().amax(dim=-1).contiguous()
    layout.mesh.all_reduce(mx, layout.mp, op="max")
    se = layout.reduce_mp(torch.exp(logits - mx[..., None]).sum(dim=-1))
    t = lab.long() - layout.i * v_loc
    inside = (t >= 0) & (t < v_loc)
    gold = torch.gather(logits, -1, t.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = layout.reduce_mp(gold * inside)
    return ((mx + torch.log(se) - gold) * m).sum()


def chunked_ce_loss(x, w_unembed, labels, loss_mask, chunk=CE_CHUNK,
                    remat: bool = False, layout=None, vocab: int = 0):
    """Cross-entropy over sequence chunks without [B, S, V] logits.  With
    ``remat`` each chunk's logits are recomputed in the backward instead of
    saved, as the reference's checkpointed chunk scan.  Where ``layout``
    splits the unembedding's ``vocab`` columns the loss is vocab-parallel
    (``_ce_chunk_parallel``)."""
    b, s, d = x.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    fn, extra = _ce_chunk, ()
    if layout is not None and w_unembed.shape[-1] != vocab:
        fn, extra = _ce_chunk_parallel, (layout,)
    for i in range(0, s, c):
        args = (x[:, i:i + c], w_unembed, labels[:, i:i + c],
                loss_mask[:, i:i + c])
        nll = checkpoint(fn, *args, *extra, use_reentrant=False) if remat \
            else fn(*args, *extra)
        tot = tot + nll
        cnt = cnt + args[3].sum()
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# the transformer family's layer groups
# ---------------------------------------------------------------------------

def _moe_whole_batch(h, moe_p: MoEParams, cfg, *, layout, lina: bool,
                     top_k=None, shortcut=None,
                     dispatch_backend: str = "scatter",
                     expert_slicing: bool = False) -> MoEOutput:
    """``moe_layer`` on this rank's rows h [B, S, d].  Over a ``layout``
    this rank takes the reference's token shard of them (batch over `data`
    if B tiles it and the rows are not split there already, sequence over
    `model` if S tiles it and the rows are not split there, else the whole
    dim), and y and the ids come back all-gathered: [B, S, d] and [B * S,
    k] in (b, s) order (the reference keeps its ids in shard order); y's
    gathers are differentiable (their backward a reduce-scatter).  Without
    one, ``lina`` has nothing to act on, as on the reference's one-device
    default mesh.

    On a Megatron-SP view h [B, S / n, d] is this rank's slice over the
    model-parallel group (`model`, then `tp`) and y comes back as that
    slice: without `tp` the slice is the `model` shard itself, so y is not
    gathered over `model` (the ids are); with `tp` the slice is 1 / tp of
    it, so the splits differ: the tp ranks' slices are gathered into the
    `model` shard first (the tp ranks of an expert slice must hold the same
    tokens), and the layer's `tp` sum becomes a reduce-scatter back to the
    slice (``moe_layer``'s ``tp_scatter``; experts whole over `tp` give a
    whole y, cut to it)."""
    if layout is None:
        return moe_layer(h, moe_p, cfg.moe, ffn_type=cfg.ffn_type,
                         dispatch_backend=dispatch_backend, top_k=top_k,
                         shortcut_params=shortcut)
    mesh, sp = layout.mesh, layout.sp
    dp_n, ep = mesh.size(axes.DATA), mesh.size(axes.EP_AXIS)
    tp = mesh.size(axes.TP) if sp else 1
    if tp > 1:
        h = gather_grad(h, mesh, mesh.group(axes.TP), 1)
    b, s, d = h.shape
    bq = axes.DATA not in layout.batch_axes and b % dp_n == 0
    sq = sp or (axes.EP_AXIS not in layout.batch_axes and s % ep == 0)
    if bq:
        i, n = mesh.index(axes.DATA), b // dp_n
        h = h[i * n:(i + 1) * n]
    if sq and not sp:
        i, n = mesh.index(axes.EP_AXIS), s // ep
        h = h[:, i * n:(i + 1) * n]
    scatter = tp > 1 and expert_slicing
    out = moe_layer(h, moe_p, cfg.moe, ffn_type=cfg.ffn_type,
                    dispatch_backend=dispatch_backend, top_k=top_k,
                    mesh=mesh, lina=lina, shortcut_params=shortcut,
                    expert_slicing=expert_slicing, tp_scatter=scatter)
    bl, sl = h.shape[:2]
    y = out.y
    eidx = out.expert_idx.reshape(bl, sl, -1)
    for go, axis, dim in ((sq, axes.EP_AXIS, 1), (bq, axes.DATA, 0)):
        if go:
            if not (sp and axis == axes.EP_AXIS):
                y = gather_grad(y, mesh, mesh.group(axis), dim)
            eidx = gather_axis(eidx, mesh, axis, dim)
    if tp > 1 and not scatter:
        k = s // tp
        y = y.narrow(1, mesh.index(axes.TP) * k, k)
    s_all = eidx.shape[1]
    return MoEOutput(y, out.aux_loss, eidx.reshape(b * s_all, -1), None)


def _plan_of(serve_plan, gi: int):
    if serve_plan is None or not serve_plan.stacked:
        return serve_plan
    return serve_plan.layer(gi)


def _moe_sublayer(cfg, gp: GroupParams, h, plan, *, layout, lina: bool,
                  serve_top_k, fuse_shortcut: bool, dispatch_backend: str):
    """The MoE sublayer on this rank's rows h [B, S, d] -> (moe_y, aux,
    top-1 id per token [B * S]), its experts [E / ep, d, f / tp] after the
    FSDP gather.  Under ``plan`` it is the plan-honoring layer, which
    reads whole experts (the reference's ``P(EP_AXIS, None, None)``), so
    their hidden slices are gathered over `tp` where its hosted stack is
    built; else ``moe_layer``, which keeps them sliced (its expert
    slicing), with ``fuse_shortcut`` taking the ScMoE shortcut into it.
    The fused shortcut runs on the layer's own tokens, so its
    tensor-parallel weights are gathered whole; the shared expert is added
    outside the plan dispatch, tensor parallel on h.

    On a Megatron-SP view h and moe_y are this rank's slice [B, S / n, d]
    (``_moe_whole_batch``); the plan-honoring layer shards tokens over
    `data` alone, so under a plan the splits differ: h is gathered whole
    first and moe_y cut back to the slice.  The ids are every token's."""
    if plan is not None and layout is not None and layout.sp:
        moe_y, aux, top1 = _moe_sublayer(
            cfg, gp, layout.whole_seq(h), plan, layout=layout.base,
            lina=lina, serve_top_k=serve_top_k,
            fuse_shortcut=fuse_shortcut, dispatch_backend=dispatch_backend)
        return layout.own_seq(moe_y), aux, top1
    mesh = None if layout is None else layout.mesh
    b, s, d = h.shape
    moe_p = gp.moe
    f_moe = cfg.moe.d_ff or cfg.d_ff
    sliced = moe_p.wi.shape[-1] != f_moe
    sc = gp.shared if fuse_shortcut and cfg.moe.shortcut else None
    if sc is not None and layout is not None:
        sc = FFNParams(*(w if w is None or w.shape[dim] == f_moe
                         else layout.gather_mp(w, dim)
                         for w, dim in ((sc.w_in, 1), (sc.w_up, 1),
                                        (sc.w_out, 0))))
    if plan is not None:
        if sliced:
            tpg = mesh.group(axes.TP)
            moe_p = moe_p._replace(
                wi=gather_grad(moe_p.wi, mesh, tpg, 2),
                wu=None if moe_p.wu is None else gather_grad(moe_p.wu, mesh,
                                                             tpg, 2),
                wo=gather_grad(moe_p.wo, mesh, tpg, 1))
        local = layout is not None and axes.DATA in layout.batch_axes
        y2, eidx, _ = serve_moe_layer(h.reshape(b * s, d), moe_p, cfg.moe,
                                      plan, ffn_type=cfg.ffn_type,
                                      top_k=serve_top_k, mesh=mesh,
                                      local=local)
        moe_y, aux, sc = y2.reshape(b, s, d), torch.zeros(
            (), device=h.device), None
    else:
        out = _moe_whole_batch(h, moe_p, cfg, layout=layout, lina=lina,
                               top_k=serve_top_k, shortcut=sc,
                               dispatch_backend=dispatch_backend,
                               expert_slicing=sliced)
        moe_y, aux, eidx = out.y, out.aux_loss, out.expert_idx
    if gp.shared is not None and sc is None:
        moe_y = moe_y + _ffn_apply(gp.shared, h, cfg.ffn_type, layout, f_moe)
    return moe_y, aux, eidx[:, 0].to(torch.int32)


def _group_apply(cfg, gp: GroupParams, x, *, plan=None, serve_top_k=None,
                 dispatch_backend: str = "scatter", lina: bool = True,
                 use_kernel: bool = False, layout=None):
    """One layer group (``moe.every`` blocks) on [B, S, d] ->
    (x, aux loss, top-1 expert per token or None).  ``use_kernel`` runs
    the flash kernel for attention (no backward); the rest is
    ``_moe_sublayer``'s, the ScMoE shortcut fused into ``moe_layer``.
    With a ``layout`` the group's stored shards ``gp`` are gathered here
    (so under remat again in the backward).  On a Megatron-SP view x is
    this rank's slice [B, S / n, d]: the norms and residual adds run on
    it, attention and the FFNs gather and scatter it (``attention``,
    ``_ffn_apply``, ``_moe_sublayer``)."""
    if layout is not None:
        gp = layout.gather(gp, layout.specs.stack, lead=1)
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1 = None
    for j in range(every):
        with region("lm.attention"):
            h = rms_norm(x, gp.ln1[j], cfg.norm_eps)
            y, _ = attention(tree_idx(gp.attn, j), h, cfg,
                             use_kernel=use_kernel, layout=layout)
            x = x + y
        if not (cfg.moe.enabled and j == every - 1):
            with region("lm.ffn"):
                h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
                x = x + _ffn_apply(tree_idx(gp.ffn, j), h, cfg.ffn_type,
                                   layout, cfg.d_ff)
            continue
        with region("lm.moe"):
            h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
            moe_y, a, top1 = _moe_sublayer(
                cfg, gp, h, plan, layout=layout, lina=lina,
                serve_top_k=serve_top_k, fuse_shortcut=True,
                dispatch_backend=dispatch_backend)
            x = x + moe_y
            aux = aux + a
    return x, aux, top1


def run_stack(cfg, stack: GroupParams, x, *, serve_plan=None,
              remat: bool = False, **kw):
    """The transformer stack on x [B, S, d] -> (x, aux, expert choices
    [n_moe_layers, B * S] or None).  ``kw`` are ``_group_apply``'s; a
    stacked ``serve_plan`` gives MoE layer g its plan g.  With ``remat``
    each group runs under ``torch.utils.checkpoint`` (non-reentrant), so
    only the group boundaries' carries are kept: on a Megatron-SP view
    (x this rank's slice [B, S / n, d], ``_stack_layout``) a slice
    each.  The range ``lm.stack`` holds the stack's own ops: a group's
    weights sliced from the stacked leaves (in the backward, its gradient
    written into theirs) and the aux losses summed."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    aux = torch.zeros((), device=x.device)
    top1s = []
    for gi in range(cfg.n_layers // every):
        with region("lm.stack"):
            gp = tree_idx(stack, gi)
        plan = _plan_of(serve_plan, gi)
        if remat:
            x, a, top1 = checkpoint(_group_apply, cfg, gp, x, plan=plan,
                                    use_reentrant=False, **kw)
        else:
            x, a, top1 = _group_apply(cfg, gp, x, plan=plan, **kw)
        with region("lm.stack"):
            aux = aux + a
        if top1 is not None:
            top1s.append(top1)
    return x, aux, torch.stack(top1s) if top1s else None


def _stack_layout(cfg, p: LMParams, layout, batch: dict):
    """The layout the stack of ``p`` runs under on ``batch``: with
    ``cfg.seq_parallel`` the transformer stack's Megatron-SP view of
    ``layout`` (``Layout.for_sequence`` of the model's sequence: the
    frames, or the patches and the tokens), else ``layout`` (the
    reference's hybrid and RWKV stacks ignore the flag)."""
    if layout is None or not cfg.seq_parallel or \
            not isinstance(p.stack, GroupParams):
        return layout
    if cfg.frontend == "audio_stub":
        return layout.for_sequence(batch["frames"].shape[1])
    patches = batch.get("patches")
    return layout.for_sequence(batch["tokens"].shape[1] + (
        0 if patches is None else patches.shape[1]))


def _top(p: LMParams, layout) -> LMParams:
    """``p`` with its leaves outside the stack FSDP-gathered."""
    if layout is None:
        return p
    top = layout.gather(p._replace(stack=None),
                        layout.specs._replace(stack=None))
    return top._replace(stack=p.stack)


def logits_of(cfg, p: LMParams, x, layout=None):
    """Logits [B, V] of x [B, d] (the unembedding's vocab split over
    ``layout``'s model-parallel ranks: gathered)."""
    w = unembed_weight(p)
    logits = x @ w
    if layout is not None and w.shape[-1] != cfg.vocab_size:
        logits = layout.gather_mp(logits, 1)
    return logits


def forward_train(cfg, params: LMParams, batch: dict, *,
                  dispatch_backend: str = "scatter", lina: bool = True,
                  layout=None) -> ModelOutput:
    """Training forward on this rank's batch: loss (CE + aux), aux loss,
    and per-MoE-layer top-1 expert choices [n_moe_layers, B*S].  ``batch``
    holds ``tokens`` and ``labels`` [B, S] tensors on the params' device.
    Without a ``layout`` it is the single-rank model; with one (see the
    module doc) ``params`` are this rank's shards, ``batch`` its rows, and
    the MoE layers run expert parallel (``core.moe.moe_layer``'s
    ``lina``).  The loss is this rank's: its mean over the ranks is the
    global loss (the same on ranks that hold the same rows).

    Differentiable in ``params`` (fp32 masters cast to ``cfg.dtype`` for
    compute).  With ``cfg.remat`` each layer group (each layer of the
    hybrid and RWKV stacks) runs under ``torch.utils.checkpoint``
    (non-reentrant): only the group boundaries are kept and the backward
    recomputes the group, kernels and all-to-alls included, as the
    reference's ``jax.checkpoint`` over the scan body.  With
    ``cfg.seq_parallel`` over a ``layout`` (``_stack_layout``) the
    transformer stack runs Megatron-SP: the embedding enters as this
    rank's sequence slice and the carry stays one between groups (the
    saved boundaries S / n tokens a rank), gathered whole before the
    final norm and the loss.  The hybrid and RWKV
    stacks' recurrences run the WKV / SSD kernels forward and backward on
    the kernel route; the shared block's attention is plain (the flash
    kernel has no backward).  They return a zero aux loss and no expert
    choices, as the reference's.

    The frontends follow the reference's branches: hubert's batch holds
    ``frames`` [B, S, FRAME_DIM] and ``labels`` [B, S]; every
    ``MASK_EVERY``-th frame is masked with ``mask_emb`` and the loss is
    taken on the masked frames only.  llava's holds ``tokens``, ``patches``
    [B, P, d] and ``labels`` [B, S_text]: the patch prefix gets zero
    labels and a zero loss mask, the text next-token labels."""
    _check_family(cfg)
    with region("lm.cast"):
        p = _top(cast_for_compute(cfg, params), layout)
    tokens = batch.get("tokens")
    stack = _stack_layout(cfg, p, layout, batch)
    if cfg.frontend == "audio_stub":
        frames = batch["frames"]
        mask = frame_mask(frames.shape[:2], frames.device)
        with region("lm.embed"):
            x = embed_inputs(cfg, p, frames=frames, mask=mask, layout=stack)
        labels, loss_mask = batch["labels"], mask.float()
    elif cfg.frontend == "vision_stub":
        with region("lm.embed"):
            x = embed_inputs(cfg, p, tokens=tokens,
                             patches=batch["patches"], layout=stack)
        lab_txt = batch["labels"]
        pad = torch.zeros((tokens.shape[0], batch["patches"].shape[1]),
                          dtype=lab_txt.dtype, device=lab_txt.device)
        labels = torch.cat([pad, lab_txt], dim=1)
        loss_mask = torch.cat([torch.zeros(pad.shape, device=x.device),
                               torch.ones(lab_txt.shape, device=x.device)],
                              dim=1)
    else:
        with region("lm.embed"):
            x = embed_inputs(cfg, p, tokens=tokens, layout=stack)
        labels = batch["labels"]
        loss_mask = torch.ones(labels.shape, device=x.device)
    if isinstance(p.stack, HybridParams):
        x = _run_hybrid(cfg, p.stack, x, attn_kernel=False, remat=cfg.remat,
                        layout=layout)
        aux, experts = torch.zeros((), device=x.device), None
    elif isinstance(p.stack, RWKVStack):
        x = _run_rwkv(cfg, p.stack, x, remat=cfg.remat, layout=layout)
        aux, experts = torch.zeros((), device=x.device), None
    else:
        x, aux, experts = run_stack(cfg, p.stack, x, remat=cfg.remat,
                                    dispatch_backend=dispatch_backend,
                                    lina=lina, layout=stack)
    with region("lm.loss"):
        if stack is not None:   # the vocab-parallel loss: every mp rank on
            x = stack.whole_seq(x)                  # every token
        x = rms_norm(x, p.final_norm, cfg.norm_eps)
        loss = chunked_ce_loss(x, unembed_weight(p), labels, loss_mask,
                               remat=cfg.remat, layout=layout,
                               vocab=cfg.vocab_size) + aux
    return ModelOutput(loss, aux, experts)


# ---------------------------------------------------------------------------
# the hybrid (zamba2) and RWKV6 families: the stacks, prefill and decode
# ---------------------------------------------------------------------------

def _taps(cfg) -> list:
    """Layers after which the shared attention block runs ("A" or "*")."""
    return [ch in "A*" for ch in cfg.layer_pattern]


def _shared_params(hp: HybridParams, layout):
    """The shared block's (attention, FFN) weights, FSDP-gathered."""
    if layout is None:
        return hp.shared_attn, hp.shared_ffn
    sp = layout.specs.stack
    return (layout.gather(hp.shared_attn, sp.shared_attn),
            layout.gather(hp.shared_ffn, sp.shared_ffn))


def _layer(tree, specs, li: int, layout):
    """Layer ``li`` of a stacked tree, FSDP-gathered over ``layout``."""
    t = tree_idx(tree, li)
    return t if layout is None else layout.gather(t, specs, lead=1)


def _shared_block(cfg, hp: HybridParams, x, use_kernel: bool, layout=None):
    attn_p, ffn_p = _shared_params(hp, layout)
    h = rms_norm(x, hp.ln_s1, cfg.norm_eps)
    y, _ = attention(attn_p, h, cfg, use_kernel=use_kernel, layout=layout)
    x = x + y
    h = rms_norm(x, hp.ln_s2, cfg.norm_eps)
    return x + _ffn_apply(ffn_p, h, cfg.ffn_type, layout, cfg.d_ff)


def _hybrid_layer(cfg, hp: HybridParams, li: int, tap: bool, x,
                  attn_kernel: bool, layout=None):
    """Mamba2 layer ``li``, then the shared block if it is a tap."""
    with region("lm.hybrid"):
        mp = _layer(hp.mamba, None if layout is None
                    else layout.specs.stack.mamba, li, layout)
        h = rms_norm(x, hp.ln_m[li], cfg.norm_eps)
        y, _ = ssm_mod.mamba_block(mp, cfg, h)
        x = x + y
        return _shared_block(cfg, hp, x, attn_kernel, layout) if tap else x


def _run_hybrid(cfg, hp: HybridParams, x, *, attn_kernel: bool,
                remat: bool = False, layout=None):
    """Mamba2 layers, the shared block after each tap.  x: [B, S, d].
    ``attn_kernel``: the shared block's attention on the flash kernel
    (serving only: it has no backward).  With ``remat`` each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant)."""
    for li, tap in enumerate(_taps(cfg)):
        if remat:
            x = checkpoint(_hybrid_layer, cfg, hp, li, tap, x, attn_kernel,
                           layout, use_reentrant=False)
        else:
            x = _hybrid_layer(cfg, hp, li, tap, x, attn_kernel, layout)
    return x


def _rwkv_layer(cfg, st: RWKVStack, li: int, x, layout=None):
    """RWKV6 layer ``li``: time-mix then channel-mix."""
    with region("lm.rwkv"):
        bp = _layer(st.blocks, None if layout is None
                    else layout.specs.stack.blocks, li, layout)
        h = rms_norm(x, st.ln1[li], cfg.norm_eps)
        y, _, _ = rwkv_mod.time_mix(bp, cfg, h)
        x = x + y
        h = rms_norm(x, st.ln2[li], cfg.norm_eps)
        y, _ = rwkv_mod.channel_mix(bp, h)
        return x + y


def _run_rwkv(cfg, st: RWKVStack, x, *, remat: bool = False, layout=None):
    """RWKV6 layers.  x: [B, S, d].  With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant)."""
    for li in range(cfg.n_layers):
        if remat:
            x = checkpoint(_rwkv_layer, cfg, st, li, x, layout,
                           use_reentrant=False)
        else:
            x = _rwkv_layer(cfg, st, li, x, layout)
    return x


def forward_prefill(cfg, params: LMParams, batch: dict, *,
                    lina: bool = False, serve_plan=None, serve_top_k=None,
                    layout=None) -> ModelOutput:
    """Serving prefill: last-position logits [B, V] in ``cfg.dtype``
    (``ModelOutput.logits``), the aux loss and, for the transformer
    family, the per-MoE-layer top-1 expert choices [n_moe_layers, B * S].
    ``batch`` holds ``tokens`` [B, S] on the params' device (this rank's
    rows over a ``layout``); hubert's ``frames`` [B, S, FRAME_DIM]
    instead (nothing masked), llava's ``tokens`` and ``patches`` [B, P, d]
    (the logits are the last text position's).  The transformer keywords
    are the reference's (see the module doc); a stacked ``serve_plan``
    gives each MoE layer its own plan (the reference's prefill takes one
    plan for every layer).  Builds no cache, as the reference's (decode starts from
    ``init_cache``).  The flash kernel has no backward: call it under
    ``torch.inference_mode`` when the params require grad.  With a
    ``layout`` (see the module doc) ``params`` are this rank's shards and
    ``batch`` its rows; the logits are whole.  Megatron-SP applies as in
    ``forward_train``; the last position's row comes from its owner, the
    last rank (one all-gather of each rank's last row)."""
    _check_family(cfg)
    p = _top(cast_for_compute(cfg, params), layout)
    stack = _stack_layout(cfg, p, layout, batch)
    x = embed_inputs(cfg, p, tokens=batch.get("tokens"),
                     patches=batch.get("patches"),
                     frames=batch.get("frames"), layout=stack)
    aux = torch.zeros((), device=x.device)
    experts = None
    if isinstance(p.stack, HybridParams):
        x = _run_hybrid(cfg, p.stack, x, attn_kernel=kernel_route(cfg),
                        layout=layout)
    elif isinstance(p.stack, RWKVStack):
        x = _run_rwkv(cfg, p.stack, x, layout=layout)
    else:
        x, aux, experts = run_stack(
            cfg, p.stack, x, lina=lina, serve_plan=serve_plan,
            serve_top_k=serve_top_k, use_kernel=kernel_route(cfg),
            layout=stack)
    if stack is not None and stack.sp:  # the last position: the last
        x = stack.whole_seq(x[:, -1:])       # rank's last row
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    logits = logits_of(cfg, p, x[:, -1], layout)
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


def _cache_split(cache: LMCache, layout) -> Optional[CacheSplit]:
    """The axes ``layout`` splits the KV cache's slots and kv heads over
    (``launch.sharding.cache_specs``), None where it splits neither."""
    if layout is None or layout.cache_specs is None or cache.kv is None:
        return None
    lead = cache.kv.k.dim() - 4
    spec = layout.cache_specs.kv.k
    split = CacheSplit(spec.axes_of(lead + 1), spec.axes_of(lead + 2))
    return split if split.seq or split.kv else None


def _decode_groups(cfg, stack: GroupParams, cache: LMCache, x, *, lina,
                   serve_plan, serve_top_k, layout=None):
    """The transformer's decode step on x [B, 1, d] -> (x, new cache,
    expert choices [n_moe_layers, B] or None)."""
    every = cfg.moe.every if cfg.moe.enabled else 1
    ks, vs, top1s = [], [], []
    split = _cache_split(cache, layout)
    for gi in range(cfg.n_layers // every):
        gp = _layer(stack, None if layout is None else layout.specs.stack,
                    gi, layout)
        ks_g, vs_g = [], []
        for j in range(every):
            h = rms_norm(x, gp.ln1[j], cfg.norm_eps)
            y, kv_new = decode_attention(
                tree_idx(gp.attn, j), h,
                KVCache(cache.kv.k[gi, j], cache.kv.v[gi, j]), cache.pos,
                cfg, layout=layout, split=split)
            ks_g.append(kv_new.k)
            vs_g.append(kv_new.v)
            x = x + y
            h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
            if not (cfg.moe.enabled and j == every - 1):
                x = x + _ffn_apply(tree_idx(gp.ffn, j), h, cfg.ffn_type,
                                   layout, cfg.d_ff)
                continue
            moe_y, _, top1 = _moe_sublayer(
                cfg, gp, h, _plan_of(serve_plan, gi), layout=layout,
                lina=lina, serve_top_k=serve_top_k, fuse_shortcut=False,
                dispatch_backend="scatter")
            x = x + moe_y
            top1s.append(top1)
        ks.append(torch.stack(ks_g))
        vs.append(torch.stack(vs_g))
    new_cache = LMCache(kv=KVCache(torch.stack(ks), torch.stack(vs)),
                        mamba=None, rwkv=None, pos=cache.pos + 1)
    return x, new_cache, torch.stack(top1s) if top1s else None


def decode_step(cfg, params: LMParams, cache: LMCache, token, *,
                lina: bool = False, serve_plan=None, serve_top_k=None,
                layout=None) -> tuple:
    """One decode step.  token: [B] on the params' device (this rank's
    rows over a ``layout``).  Returns (logits [B, V], cache,
    expert_choices): the per-MoE-layer top-1 expert of each row
    [n_moe_layers, B] for the transformer family (callers roll path-ID
    state with it), None for the hybrid and RWKV stacks, as the reference
    returns.  The transformer keywords are the reference's (see the module
    doc; a stacked ``serve_plan`` gives each MoE layer its own plan); its
    attention is the plain ``decode_attention``.  Mamba2 layers run
    ``mamba_decode`` (plain), the shared block the plain
    ``decode_attention``; each RWKV6 layer runs the WKV op at T = 1 from
    its cached state (the kernel on the kernel route).  llava decodes text
    tokens only, as the reference's; an encoder-only config raises.  With
    a ``layout`` (see the module doc) ``params`` are this rank's shards,
    ``token`` and ``cache`` its rows, the cache's sequence split as
    ``layout.cache_specs`` says; the logits are whole."""
    _check_decodes(cfg)
    p = _top(cast_for_compute(cfg, params), layout)
    x = lookup(cfg, p.embed, token, layout)[:, None].to(
        DTYPES[cfg.dtype])                                      # [B,1,d]
    pos = cache.pos
    eps = cfg.norm_eps
    if isinstance(p.stack, GroupParams):
        x, new_cache, experts = _decode_groups(
            cfg, p.stack, cache, x, lina=lina, serve_plan=serve_plan,
            serve_top_k=serve_top_k, layout=layout)
        x = rms_norm(x, p.final_norm, eps)
        return logits_of(cfg, p, x[:, 0], layout), new_cache, experts
    if isinstance(p.stack, HybridParams):
        hp = p.stack
        split = _cache_split(cache, layout)
        attn_p, ffn_p = _shared_params(hp, layout)
        states, ks, vs = [], [], []
        for li, tap in enumerate(_taps(cfg)):
            h = rms_norm(x, hp.ln_m[li], eps)
            mp = _layer(hp.mamba, None if layout is None
                        else layout.specs.stack.mamba, li, layout)
            y, ms_new = ssm_mod.mamba_decode(mp, cfg, h,
                                             tree_idx(cache.mamba, li))
            states.append(ms_new)
            x = x + y
            if tap:
                h = rms_norm(x, hp.ln_s1, eps)
                y, kv_new = decode_attention(
                    attn_p, h, tree_idx(cache.kv, len(ks)), pos, cfg,
                    layout=layout, split=split)
                ks.append(kv_new.k)
                vs.append(kv_new.v)
                x = x + y
                h2 = rms_norm(x, hp.ln_s2, eps)
                x = x + _ffn_apply(ffn_p, h2, cfg.ffn_type, layout, cfg.d_ff)
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
            bp = _layer(st.blocks, None if layout is None
                        else layout.specs.stack.blocks, li, layout)
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
    return logits_of(cfg, p, x[:, 0], layout), new_cache, None
