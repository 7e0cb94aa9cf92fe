"""Analytic FLOP / HBM-traffic model per (arch x shape): a copy of the
reference's ``src/repro/launch/analytic.py`` on the port's configs (the
same arithmetic, so the same numbers to the last bit).

Why analytic: a whole step's FLOPs and bytes come from the
architecture's exact math (the MaxText-MFU approach), not from counting
kernels, so they are the denominator of a model-FLOP share on any
device.  ``launch.dryrun`` divides them by the card's data-sheet rates
(``configs.H100``) for its roofline terms.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class AnalyticCost:
    flops_global: float          # FLOPs for one step
    hbm_bytes_global: float      # HBM traffic for one step
    matmul_params: float         # params participating in matmuls (active)
    notes: str = ""


def _matmul_params_active(cfg: ModelConfig) -> float:
    """Active matmul params per token (excludes embedding lookup, includes
    the unembedding projection)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    ffn_mult = 3 if cfg.ffn_type == "swiglu" else 2
    attn = 2 * (cfg.n_heads * hd * d) + 2 * (cfg.n_kv_heads * hd * d)
    total = v * d  # unembed
    if cfg.layer_pattern:
        pat = cfg.layer_pattern
        n_m = len(pat)
        d_in = d * cfg.ssm.expand
        n = cfg.ssm.d_state
        per_mamba = d * (2 * d_in + 2 * n + d_in // cfg.ssm.head_dim) + d_in * d
        total += n_m * per_mamba
        total += pat.count("*") * (attn + ffn_mult * d * f)
    elif cfg.attention_free:
        total += cfg.n_layers * (5 * d * d + d * 64 + 3 * d * f)
    else:
        total += cfg.n_layers * attn
        n_moe = cfg.n_moe_layers
        n_dense = cfg.n_layers - n_moe
        total += n_dense * ffn_mult * d * f
        if cfg.moe.enabled:
            e_f = cfg.moe.d_ff or f
            per_exp = ffn_mult * d * e_f
            total += n_moe * (cfg.moe.top_k + (1 if cfg.moe.shared_expert
                                               else 0)) * per_exp
            total += n_moe * d * cfg.moe.n_experts  # router
    return float(total)


def _attention_flops(cfg: ModelConfig, b: int, s_q: int, s_kv: int,
                     fwd_mult: float) -> float:
    """QK^T + PV flops; causal halves the effective context."""
    if cfg.attention_free:
        return 0.0
    if cfg.layer_pattern:
        n_attn = sum(ch in "A*" for ch in cfg.layer_pattern)
    else:
        n_attn = cfg.n_layers
    eff_kv = s_kv
    if cfg.sliding_window:
        eff_kv = min(s_kv, cfg.sliding_window)
    elif cfg.causal and s_q == s_kv:
        eff_kv = s_kv / 2
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    return fwd_mult * 2.0 * 2.0 * b * s_q * eff_kv * d_attn * n_attn


def _ssm_scan_flops(cfg: ModelConfig, tokens: float, fwd_mult: float) -> float:
    """Chunked-scan state math (intra-chunk matmuls + state updates)."""
    if cfg.layer_pattern:           # mamba2
        d_in = cfg.d_model * cfg.ssm.expand
        n = cfg.ssm.d_state
        q = cfg.ssm.chunk
        # per token: intra M@X ~ 2*q*d_in, CB ~ 2*q*n, state update ~ 4*d_in*n
        per_tok = 2 * q * d_in + 2 * q * n + 4 * d_in * n
        return fwd_mult * per_tok * tokens * len(cfg.layer_pattern)
    if cfg.attention_free:          # rwkv6
        hd = cfg.ssm.head_dim
        per_tok = 4 * cfg.d_model * hd   # S update + readout per head
        return fwd_mult * per_tok * tokens * cfg.n_layers
    return 0.0


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig) -> AnalyticCost:
    b, s = shape.global_batch, shape.seq_len
    n_mm = _matmul_params_active(cfg)
    p_total = cfg.param_count()
    act_bytes = 2  # bf16 activations
    d = cfg.d_model

    if shape.kind == "train":
        tokens = float(b) * s
        flops = 6.0 * n_mm * tokens
        flops += _attention_flops(cfg, b, s, s, fwd_mult=3.0)
        flops += _ssm_scan_flops(cfg, tokens, 3.0)
        # HBM: weights fwd + bwd reads (compute dtype) + grad write +
        # optimizer (read p,m,v + write p,m,v in state dtype) + remat
        # activation traffic (write carry, read back, recompute ~2x reads)
        w_c = 2 * p_total * act_bytes
        opt_b = {"float32": 4, "bfloat16": 2}[cfg.opt_state_dtype]
        opt = p_total * (2 * 4 + 4 * opt_b)  # master rw + m,v rw
        acts = 4.0 * cfg.n_layers * tokens * d * act_bytes
        hbm = w_c + opt + acts
        note = "6ND + 12BS^2 attn; remat act traffic 4LTd"
    elif shape.kind == "prefill":
        tokens = float(b) * s
        flops = 2.0 * n_mm * tokens
        flops += _attention_flops(cfg, b, s, s, fwd_mult=1.0)
        flops += _ssm_scan_flops(cfg, tokens, 1.0)
        hbm = p_total * act_bytes + 2.0 * cfg.n_layers * tokens * d * act_bytes
        note = "2ND fwd"
    else:  # decode / long_decode: one token, seq_len-deep cache
        tokens = float(b)
        flops = 2.0 * n_mm * tokens
        flops += _attention_flops(cfg, b, 1, s, fwd_mult=1.0)
        flops += _ssm_scan_flops(cfg, tokens, 1.0)
        # decode is weight+cache bound: all weights read once per step,
        # full KV cache (or SSM state) read once
        if cfg.attention_free or cfg.layer_pattern:
            d_in = d * max(cfg.ssm.expand, 1)
            state = cfg.n_layers * b * d_in * cfg.ssm.d_state * 4
            if cfg.attention_free:
                state = cfg.n_layers * b * d * cfg.ssm.head_dim * 4
            cache_bytes = 2 * state
        else:
            eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
            n_attn = cfg.n_layers
            cache_bytes = (2 * n_attn * b * eff * cfg.n_kv_heads
                           * cfg.resolved_head_dim * 2)
        hbm = p_total * act_bytes + cache_bytes
        note = "2ND + cache read"
    return AnalyticCost(flops, hbm, n_mm, note)
