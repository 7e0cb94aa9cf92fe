"""GQA/MQA/MHA attention with qk-norm, QKV bias, sliding window and RoPE:
full-sequence (prefill) and one-token decode against a KV cache.

Plain tensor code, as in the reference (its models never call the Pallas
flash-attention kernel).  Layouts follow the reference: q [B, S, H, hd],
k/v [B, S, KV, hd].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
                 rope_theta, norm_eps):
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
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


def _sdpa(q, k, v, *, causal, window):
    """Reference attention.  q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd]."""
    b, sq, h, hd = q.shape
    rep = h // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (hd ** 0.5)
    sk = k.shape[1]
    qpos = torch.arange(sq, device=q.device)
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


def attention(p: AttnParams, x, cfg):
    """Full-sequence path (prefill / profiling).  x: [B, S, d] ->
    (y [B, S, d], KVCache(k, v) of this layer)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, hd, positions,
                           cfg.rope_theta, cfg.norm_eps)
    o = _sdpa(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    o = o.reshape(b, s, cfg.n_heads * hd)
    return o @ p.wo, KVCache(k, v)


def decode_attention(p: AttnParams, x, cache: KVCache, pos, cfg):
    """One-token decode.  x: [B, 1, d]; pos: [B] absolute position; the
    cache holds S_max slots (ring-buffered with a sliding window).  Returns
    (y, KVCache) with the new token written into a copy of the cache."""
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
    k[rows, slot.long()] = k_new[:, 0]
    v[rows, slot.long()] = v_new[:, 0]

    rep = cfg.n_heads // cfg.n_kv_heads
    kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
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
