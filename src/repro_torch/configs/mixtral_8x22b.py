"""mixtral-8x22b — MoE 8e top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,         # SWA => long_500k decode runs (bounded KV)
    moe=MoEConfig(
        n_experts=8,
        top_k=2,                 # matches Lina's training setting (k=2)
        d_ff=16384,
        every=1,
        capacity_factor=1.25,
        n_microops=4,
        pipeline_ffn=True,
    ),
    opt_state_dtype="bfloat16",
    notes="Every layer MoE; top-2 routing as in the paper's training setup.",
)
