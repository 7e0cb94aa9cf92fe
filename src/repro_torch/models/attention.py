"""GQA/MQA/MHA attention with qk-norm, QKV bias, sliding window and RoPE:
full-sequence (prefill) and one-token decode against a KV cache.

The full-sequence path is plain tensor code, as in the reference: the
O(S^2)-memory ``_sdpa`` up to ``BLOCKWISE_THRESHOLD`` tokens, the
query-blocked ``_sdpa_blockwise`` beyond.  With ``use_kernel`` (the
server's kernel route) it calls ``kernels.ops.flash_attention_op`` instead,
the same function: the Hopper flash kernel on a CUDA tensor.  That op has
no backward, so the training forward keeps the plain path.  Decode stays
plain: the kernel does not compute the ring-buffer mask of the cache.
Layouts follow the reference: q [B, S, H, hd], k/v [B, S, KV, hd].

With a ``layout`` (``launch.sharding.Layout``) the weights are this rank's
model-parallel shards (after the FSDP gather), as the reference's
``constrain(q, P(dp, None, tp, None))``: where the heads split over the
``n`` model-parallel ranks, q / k / v are column-parallel and give this
rank's heads, ``wo`` is row-parallel and its partial output is summed by
one all-reduce.  kv heads split only where their count divides ``n``;
else k and v are computed whole from gathered weights and this rank keeps
the kv heads its q heads read, so the flash kernel's ``h // group``
mapping holds on the local heads (qwen3-8b on 16 ranks: 2 q heads against
kv head r // 2).  Where the heads do not split (llava-next-34b's 56 on 16),
the weights stay stored split but are gathered before use and attention
is computed whole.  Decode reads a cache whose sequence is split over the
model-parallel ranks (``launch.sharding.cache_specs``): the rank owning
the step's slot writes it, each rank attends its slice with every head,
and the partial (max, sum, weighted V) is combined with one max and two
sum all-reduces.  The cache's other splits (the dry run's variants) are
read the same way: under ``kv_split`` its kv heads go over `model` and its
sequence over `tp`, so each rank attends with the q heads of its kv heads
only, combines over `tp` and all-gathers the heads' outputs over `model`;
under ``cache_batch_only`` every rank holds its rows' whole cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import gather_group
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.layers import rms_norm, rope


class AttnParams(NamedTuple):
    wq: torch.Tensor                  # [d, H*hd]
    wk: torch.Tensor                  # [d, KV*hd]
    wv: torch.Tensor                  # [d, KV*hd]
    wo: torch.Tensor                  # [H*hd, d]
    bq: Optional[torch.Tensor]        # [H*hd] or None
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]
    q_norm: Optional[torch.Tensor]    # [hd] qk_norm scales
    k_norm: Optional[torch.Tensor]


class KVCache(NamedTuple):
    k: torch.Tensor                   # [..., B, S_max, KV, hd]
    v: torch.Tensor


def _project_qkv(p: AttnParams, x, n_heads, n_kv_heads, head_dim, positions,
                 rope_theta, norm_eps, cols=None):
    """q [B, S, H, hd], k / v [B, S, KV, hd], normed and rotated.
    ``cols``, where given, maps each projection (bias added) and its
    whole width to its whole columns (the decode step's all-gather of
    column-parallel products)."""
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cols is not None:
        q = cols(q, n_heads * head_dim)
        k, v = (cols(t, n_kv_heads * head_dim) for t in (k, v))
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, norm_eps)
        k = rms_norm(k, p.k_norm, norm_eps)
    if rope_theta > 0:
        q, k = rope(q, k, positions, rope_theta)
    return q, k, v


def _repeat_kv(k, rep: int):
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def _sdpa(q, k, v, *, causal, window, q_offset=0):
    """Reference attention.  q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd]; query i
    sits at position q_offset + i."""
    b, sq, h, hd = q.shape
    rep = h // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (hd ** 0.5)
    sk = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


BLOCKWISE_THRESHOLD = 2048   # S beyond which the O(S^2)-memory path is unsafe
BLOCK_Q = 1024


def _sdpa_blockwise(q, k, v, *, causal, window, block_q=BLOCK_Q):
    """Memory-bounded attention: ``_sdpa`` over query blocks (the logits
    peak at [B, H, block_q, S] instead of [B, H, S, S]); each block sees
    every key, so a plain softmax per block is exact."""
    s = q.shape[1]
    bq = min(block_q, s)
    while s % bq:
        bq -= 1
    return torch.cat([_sdpa(q[:, i:i + bq], k, v, causal=causal,
                            window=window, q_offset=i)
                      for i in range(0, s, bq)], dim=1)


class Heads(NamedTuple):
    """How many q and kv heads this rank computes, and whether its output
    is a partial sum over the model-parallel group (tensor
    parallelism)."""
    hl: int
    kvl: int
    partial: bool


def _cols(w, lo: int, n: int):
    return None if w is None else w.narrow(-1, lo, n)


def _split(p: AttnParams, cfg) -> bool:
    """Whether ``p`` holds a model-parallel shard of some weight."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return (p.wq.shape[-1] != h * hd or p.wk.shape[-1] != kv * hd
            or p.wo.shape[-2] != h * hd)


def tp_weights(p: AttnParams, cfg, layout):
    """(the weights this rank computes with, its ``Heads``) from its
    model-parallel shards (see the module doc)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if layout is None or layout.n == 1 or not _split(p, cfg):
        return p, Heads(h, kv, False)
    n, i = layout.n, layout.i

    def whole(w, full, dim=-1):
        if w is None or w.shape[dim] == full:
            return w
        return layout.gather_mp(w, w.dim() + dim if dim < 0 else dim)
    if h % n:
        p = p._replace(wq=whole(p.wq, h * hd), wk=whole(p.wk, kv * hd),
                       wv=whole(p.wv, kv * hd), wo=whole(p.wo, h * hd, -2),
                       bq=whole(p.bq, h * hd), bk=whole(p.bk, kv * hd),
                       bv=whole(p.bv, kv * hd))
        return p, Heads(h, kv, False)
    hl = h // n
    if kv % n == 0:
        return p, Heads(hl, kv // n, True)
    wk, wv = whole(p.wk, kv * hd), whole(p.wv, kv * hd)
    bk, bv = whole(p.bk, kv * hd), whole(p.bv, kv * hd)
    g = h // kv
    if hl % g and g % hl:
        raise NotImplementedError(
            f"{cfg.name}: {hl} q heads a rank straddle kv groups of {g}")
    kv0, kvl = i * hl // g, max(1, hl // g)
    p = p._replace(wk=_cols(wk, kv0 * hd, kvl * hd),
                   wv=_cols(wv, kv0 * hd, kvl * hd),
                   bk=_cols(bk, kv0 * hd, kvl * hd),
                   bv=_cols(bv, kv0 * hd, kvl * hd))
    return p, Heads(hl, kvl, True)


def attention(p: AttnParams, x, cfg, *, use_kernel: bool = False,
              layout=None):
    """Full-sequence path (prefill / profiling / training).  x: [B, S, d]
    -> (y [B, S, d], KVCache(k, v) of this layer: this rank's kv heads).
    ``use_kernel`` takes the flash-attention op (forward only) instead of
    the plain path; ``layout`` runs it tensor parallel (module doc).  On a
    Megatron-SP view (``launch.sharding.Layout.for_sequence``) x and y are
    this rank's sequence slice [B, S / n, d]: x is gathered whole first,
    and the row-parallel partial output is reduce-scattered back to the
    slice (a whole one, where the heads do not split, is cut to it); k and
    v are the whole sequence's."""
    if layout is not None:
        x = layout.whole_seq(x)
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    p, hs = tp_weights(p, cfg, layout)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(p, x, hs.hl, hs.kvl, hd, positions,
                           cfg.rope_theta, cfg.norm_eps)
    if use_kernel:
        o = flash_attention_op(q, k, v, causal=cfg.causal,
                               window=cfg.sliding_window)
    elif s > BLOCKWISE_THRESHOLD:
        o = _sdpa_blockwise(q, k, v, causal=cfg.causal,
                            window=cfg.sliding_window)
    else:
        o = _sdpa(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    o = o.reshape(b, s, hs.hl * hd)
    y = o @ p.wo
    if layout is not None:
        y = layout.reduce_out(y, hs.partial)
    return y, KVCache(k, v)


class CacheSplit(NamedTuple):
    """The axes a KV cache [.., B, S_max, KV, hd] splits its slots and its
    kv heads over (``launch.sharding.cache_specs``; () for whole)."""
    seq: tuple
    kv: tuple


def _group_of(mesh, names):
    """(group, its size, this rank's index) over the axes ``names``; no
    group, one rank, for none."""
    g = mesh.group_for(names) if names else None
    return (g, 1, 0) if g is None else \
        (g, mesh.group_size(g), mesh.group_index(g))


def _decode_parallel(p: AttnParams, x, cache: KVCache, pos, cfg, layout,
                     split: Optional[CacheSplit]):
    """``decode_attention`` over ``layout`` (see the module doc): the
    cache [B, S_max / sn, KV / kn, hd], its slots split over the ``sn``
    ranks of ``split.seq``, its kv heads over the ``kn`` of ``split.kv``
    (whole without a ``split``).  Every rank computes the step's token with
    every head: its columns of each projection, all-gathered (a token's,
    not the weights); it attends with the q heads of its kv heads (every
    head where they are whole), combines the partial softmax over the
    slots' group, gathers the heads' outputs over the kv heads' group and
    multiplies its rows of ``wo`` over its block of them, summed by one
    all-reduce."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mesh, mp = layout.mesh, layout.mp

    def cols(t, full):
        return t if t.shape[-1] == full else gather_group(t, mesh, mp, 2)
    q, k_new, v_new = _project_qkv(p, x, h, kv, hd,
                                   pos[:, None], cfg.rope_theta,
                                   cfg.norm_eps, cols=cols)
    split = split or CacheSplit((), ())
    sg, sn, si = _group_of(mesh, split.seq)
    kg, kn, ki = _group_of(mesh, split.kv)
    if kn > 1:                          # this rank's kv heads and their q
        kvl = kv // kn
        hq = kvl * (h // kv)
        q = q[:, :, ki * hq:(ki + 1) * hq]
        k_new = k_new[:, :, ki * kvl:(ki + 1) * kvl]
        v_new = v_new[:, :, ki * kvl:(ki + 1) * kvl]
    s_loc = cache.k.shape[1]
    s_max = s_loc * sn
    slot = pos % s_max if cfg.sliding_window else \
        torch.clamp(pos, max=s_max - 1)
    # every row writes its slot if this rank owns it, else rewrites the
    # value there (no shape that depends on the data)
    mine = ((slot // s_loc) == si)[:, None, None]
    rows = torch.arange(b, device=x.device)
    lslot = torch.clamp(slot - si * s_loc, 0, s_loc - 1).long()
    k = cache.k.clone()
    v = cache.v.clone()
    k[rows, lslot] = torch.where(mine, k_new[:, 0].to(k.dtype),
                                 k[rows, lslot])
    v[rows, lslot] = torch.where(mine, v_new[:, 0].to(v.dtype),
                                 v[rows, lslot])

    rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(k, rep).to(q.dtype)
    vv = _repeat_kv(v, rep).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() / hd ** 0.5
    kpos = (torch.arange(s_loc, device=x.device) + si * s_loc)[None, :]
    if cfg.sliding_window:
        age = (slot[:, None] - kpos) % s_max
        valid = age < torch.clamp(pos[:, None] + 1, max=s_max)
    else:
        valid = kpos <= pos[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=x.device))
    m = logits.amax(dim=-1, keepdim=True)
    if sn > 1:
        mesh.all_reduce(m, sg, op="max")
    e = torch.exp(logits - m)
    tot = e.sum(dim=-1, keepdim=True)
    if sn > 1:
        mesh.all_reduce(tot, sg)
    probs = (e / tot).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vv).contiguous()
    if sn > 1:
        mesh.all_reduce(o, sg)
    if kn > 1:
        o = gather_group(o, mesh, kg, 2)
    o = o.reshape(b, 1, h * hd)
    rows = p.wo.shape[-2]
    if rows == h * hd:
        return o @ p.wo, KVCache(k, v)
    y = o[..., layout.i * rows:(layout.i + 1) * rows] @ p.wo
    mesh.all_reduce(y, mp)
    return y, KVCache(k, v)


def decode_attention(p: AttnParams, x, cache: KVCache, pos, cfg,
                     layout=None, split: Optional[CacheSplit] = None):
    """One-token decode.  x: [B, 1, d]; pos: [B] absolute position; the
    cache holds S_max slots (ring-buffered with a sliding window).  Returns
    (y, KVCache) with the new token written into a copy of the cache.
    With a ``layout`` it runs tensor parallel where the weights are split
    and (``split``: the cache holds this rank's slice of the slots or of
    the kv heads) sequence parallel, no autograd; with whole weights and
    cache, or over a model-parallel group of one rank, it is this plain
    step."""
    if layout is not None and layout.n > 1 and (split is not None or
                                                 _split(p, cfg)):
        return _decode_parallel(p, x, cache, pos, cfg, layout, split)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, hd,
                                   pos[:, None], cfg.rope_theta,
                                   cfg.norm_eps)
    s_max = cache.k.shape[1]
    slot = pos % s_max if cfg.sliding_window else \
        torch.clamp(pos, max=s_max - 1)
    rows = torch.arange(b, device=x.device)
    k = cache.k.clone()
    v = cache.v.clone()
    # a cache may be kept in another dtype than the model computes in
    # (``lm.init_cache`` defaults to bf16): stored in its own, read in x's
    k[rows, slot.long()] = k_new[:, 0].to(k.dtype)
    v[rows, slot.long()] = v_new[:, 0].to(v.dtype)

    rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(k, rep).to(q.dtype)
    vv = _repeat_kv(v, rep).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() / hd ** 0.5
    kpos = torch.arange(s_max, device=x.device)[None, :]
    if cfg.sliding_window:
        age = (slot[:, None] - kpos) % s_max
        valid = age < torch.clamp(pos[:, None] + 1, max=s_max)
    else:
        valid = kpos <= pos[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vv).reshape(
        b, 1, cfg.n_heads * hd)
    return o @ p.wo, KVCache(k, v)
