"""Model FLOPs of a step: a frozen copy of the arithmetic of
``repro_torch/launch/analytic.py`` (``_matmul_params_active``,
``_attention_flops``, ``_ssm_scan_flops`` and the FLOP lines of
``analytic_cost``), on a configuration file's ``model`` dict.  It counts
the architecture's math (6ND + attention for a train step, 2ND +
attention for a prefill); recomputation is not counted."""
from __future__ import annotations

H100_BF16_FLOPS = 989e12      # NVIDIA H100 SXM data sheet, dense bf16


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // max(m["n_heads"], 1)


def _moe(m: dict) -> dict:
    return m.get("moe") or {"n_experts": 0}


def _n_moe_layers(m: dict) -> int:
    moe = _moe(m)
    return m["n_layers"] // moe.get("every", 1) if moe["n_experts"] else 0


def matmul_params_active(m: dict) -> float:
    d, f, v = m["d_model"], m["d_ff"], m["vocab_size"]
    hd = _hd(m)
    ffn_mult = 3 if m.get("ffn_type", "swiglu") == "swiglu" else 2
    attn = 2 * (m["n_heads"] * hd * d) + 2 * (m["n_kv_heads"] * hd * d)
    total = v * d  # unembed
    pat = m.get("layer_pattern", "")
    ssm = m.get("ssm", {})
    if pat:
        d_in = d * ssm["expand"]
        n = ssm["d_state"]
        per_mamba = d * (2 * d_in + 2 * n + d_in // ssm["head_dim"]) \
            + d_in * d
        total += len(pat) * per_mamba
        total += pat.count("*") * (attn + ffn_mult * d * f)
    elif m["n_heads"] == 0:
        total += m["n_layers"] * (5 * d * d + d * 64 + 3 * d * f)
    else:
        total += m["n_layers"] * attn
        n_moe = _n_moe_layers(m)
        total += (m["n_layers"] - n_moe) * ffn_mult * d * f
        moe = _moe(m)
        if moe["n_experts"]:
            per_exp = ffn_mult * d * (moe.get("d_ff") or f)
            total += n_moe * (moe["top_k"] + (1 if moe.get("shared_expert")
                                              else 0)) * per_exp
            total += n_moe * d * moe["n_experts"]  # router
    return float(total)


def attention_flops(m: dict, b: int, s_q: int, s_kv: int,
                    fwd_mult: float) -> float:
    """QK^T + PV flops; causal halves the effective context."""
    if m["n_heads"] == 0:
        return 0.0
    pat = m.get("layer_pattern", "")
    n_attn = sum(ch in "A*" for ch in pat) if pat else m["n_layers"]
    eff_kv = s_kv
    if m.get("sliding_window"):
        eff_kv = min(s_kv, m["sliding_window"])
    elif m.get("causal", True) and s_q == s_kv:
        eff_kv = s_kv / 2
    d_attn = m["n_heads"] * _hd(m)
    return fwd_mult * 2.0 * 2.0 * b * s_q * eff_kv * d_attn * n_attn


def ssm_scan_flops(m: dict, tokens: float, fwd_mult: float) -> float:
    pat = m.get("layer_pattern", "")
    ssm = m.get("ssm", {})
    if pat:
        d_in = m["d_model"] * ssm["expand"]
        n, q = ssm["d_state"], ssm["chunk"]
        per_tok = 2 * q * d_in + 2 * q * n + 4 * d_in * n
        return fwd_mult * per_tok * tokens * len(pat)
    if m["n_heads"] == 0:
        return fwd_mult * 4 * m["d_model"] * ssm["head_dim"] * tokens \
            * m["n_layers"]
    return 0.0


def step_flops(m: dict, kind: str, b: int, s: int) -> float:
    """FLOPs of one ``kind`` ("train" | "prefill") step of b x s tokens."""
    n_mm = matmul_params_active(m)
    tokens = float(b) * s
    if kind == "train":
        return 6.0 * n_mm * tokens + attention_flops(m, b, s, s, 3.0) \
            + ssm_scan_flops(m, tokens, 3.0)
    if kind == "prefill":
        return 2.0 * n_mm * tokens + attention_flops(m, b, s, s, 1.0) \
            + ssm_scan_flops(m, tokens, 1.0)
    raise ValueError(f"unknown step kind {kind!r}")
