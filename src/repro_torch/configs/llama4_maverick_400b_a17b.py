"""llama4-maverick-400b-a17b — MoE 128e top-1, interleaved MoE + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
400B total / 17B active: MoE every 2nd layer (24 of 48), 128 routed experts
(top-1) each d_ff=8192, plus an always-on shared expert; dense layers use a
16384 SwiGLU FFN.  This is the paper-representative Lina cell (a2a micro-op
scheduling + popularity placement both fully apply).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                 # dense (non-MoE) layers
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_ff=8192,              # routed-expert hidden
        every=2,                # interleave_moe_layer_step=2
        shared_expert=True,
        capacity_factor=1.25,
        n_microops=4,
        pipeline_ffn=True,
    ),
    param_dtype="bfloat16",      # 400B: fp32 master would overflow HBM
    opt_state_dtype="bfloat16",
    notes="Early-fusion multimodality out of scope (text path only).",
)
