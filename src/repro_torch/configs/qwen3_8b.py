"""qwen3-8b — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="Qwen3-8B: RMSNorm on q/k heads, SwiGLU, no QKV bias.",
)
