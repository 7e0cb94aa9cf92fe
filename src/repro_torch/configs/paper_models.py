"""The paper's own benchmark models (§7.1), as MoE-converted configs.

All FFN layers are converted to MoE layers (every=1); top-2 gating in
training, top-1 in inference, following [23] and the paper's setup.  The
expert count is a parameter (2/4/8/16 in the paper); helpers below build the
exact variants used by the benchmark harness.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, MoEConfig


def _moe(n_experts: int, top_k: int = 2) -> MoEConfig:
    return MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=0, every=1,
                     capacity_factor=1.25, n_microops=4, pipeline_ffn=True)


# Transformer-XL (24L encoder in the paper's training set; the 12/24/36L +
# param sizes of Table 1 come from scaling this base).
TRANSFORMER_XL = ModelConfig(
    name="transformer-xl-moe",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=32000,
    ffn_type="gelu",
    moe=_moe(16),
    notes="Paper §7.1 training model (Enwik8 text generation at inference).",
)

GPT2_MOE = ModelConfig(
    name="gpt2-moe",
    family="moe",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50257,
    ffn_type="gelu",
    moe=_moe(16),
    notes="Paper §7.1: 12-layer decoder.",
)

BERT2GPT2 = ModelConfig(
    name="bert2gpt2-moe",
    family="moe",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    ffn_type="gelu",
    moe=_moe(16),
    notes="Paper §7.1: 12-layer encoder-decoder (modelled as a 12L stack).",
)

BERT_LARGE = ModelConfig(
    name="bert-large-moe",
    family="moe",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    ffn_type="gelu",
    causal=False,
    moe=_moe(16, top_k=1),
    notes="Paper §7.1 inference model (WMT En-De translation).",
)


def with_experts(cfg: ModelConfig, n_experts: int, top_k: int = None) -> ModelConfig:
    k = top_k if top_k is not None else cfg.moe.top_k
    return replace(cfg, name=f"{cfg.name}-{n_experts}e",
                   moe=replace(cfg.moe, n_experts=n_experts, top_k=k))
