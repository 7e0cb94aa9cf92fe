"""qwen1.5-0.5b — dense, MHA w/ QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,           # MHA (GQA kv=16 == heads)
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    notes="Qwen1.5-0.5B: QKV bias, tied embeddings, SwiGLU.",
)
