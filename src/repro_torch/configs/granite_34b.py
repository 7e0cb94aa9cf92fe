"""granite-34b — dense code LM, llama-arch w/ MQA. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,            # MQA (GQA kv=1)
    d_ff=24576,
    vocab_size=49152,
    ffn_type="gelu",         # GPT-BigCode style 4x MLP
    qkv_bias=True,
    notes="IBM Granite Code 34B: MQA, 4x GELU MLP.",
)
